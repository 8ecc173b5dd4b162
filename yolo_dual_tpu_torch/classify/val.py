"""Classification validation CLI: top-1 and top-5 accuracy (port of
classify/val.py; reference classify/val.py:1-170).

    python -m yolo_dual_tpu_torch.classify.val --weights runs/train-cls/exp/best.pt \
        --model yolov5s.yaml --data-dir DIR
    python -m yolo_dual_tpu_torch.classify.val --model resnet18 --data-dir DIR --device cpu

The data directory holds `val/` (or `test/`), a folder a class of image files
or RGB uint8 `.npy` frames (data/classify.py), center-cropped and resized on
the host. --weights takes a `.pt` of classify.train (its EMA weights), a
state_dict, or an orbax checkpoint directory of the JAX package (its EMA
first), loaded strictly; without it the model has JAX's initial weights
under PRNGKey(0). --verbose logs the per-class table; --plots saves the first
batch's mosaic with true and predicted classes as `save_dir`/val_images.jpg
(utils/plots.py:imshow_cls, matplotlib).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.classify.train import build_classifier, topk_hits
from yolo_dual_tpu_torch.data.classify import ClassificationDataset, denormalize_imagenet
from yolo_dual_tpu_torch.data.loader import Loader
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.utils.general import LOGGER, select_device
from yolo_dual_tpu_torch.utils.plots import imshow_cls


def run(weights="", model="yolov5n.yaml", data_dir="", imgsz=224, batch_size=64, cutoff=10,
        device="cuda", verbose=False, plots=False, save_dir=".", **kw):
    """Evaluate; returns (top1, top5). The eval loop's logits of every image,
    in the dataset's order, stay readable afterwards as `run.logits`."""
    dev = select_device(device)
    data = Path(data_dir)
    ds = ClassificationDataset(data / ("val" if (data / "val").exists() else "test"), imgsz,
                               augment=False)
    loader = Loader(ds, batch_size, drop_last=False)
    nc = len(ds.classes)
    m = build_classifier(model, nc, cutoff=cutoff, device=dev)
    if weights:
        m.load_state_dict(resolve_state_dict(weights), strict=True)
    else:
        flax_init_(m)
    m.eval()
    hits1, hits5, labels, logits = [], [], [], []
    first = None  # the first batch (images, labels, logits) for --plots
    for batch in loader:
        with torch.inference_mode():
            x = torch.from_numpy(batch["image"]).to(dev).permute(0, 3, 1, 2)
            out = m(x).float().cpu().numpy()
        if first is None:
            first = (batch["image"], batch["label"], out)
        bsz = int(batch["n_valid"])
        lab = batch["label"][:bsz]
        hit1, hit5 = topk_hits(out[:bsz], lab)
        hits1.append(hit1), hits5.append(hit5), labels.append(lab), logits.append(out[:bsz])
    hit1, hit5, labels = np.concatenate(hits1), np.concatenate(hits5), np.concatenate(labels)
    run.logits = np.concatenate(logits)
    if plots and first is not None:
        # the first batch with true and predicted captions (JAX classify/val.py:65-76;
        # reference imshow_cls), its ImageNet normalisation undone for display
        ims, labs, lgt = first
        f = imshow_cls(denormalize_imagenet(ims), labels=labs, pred=np.argsort(-lgt, axis=1)[:, 0],
                       names=ds.classes, f=Path(save_dir) / "val_images.jpg")
        LOGGER.info(f"mosaic saved to {f}")
    n = max(len(labels), 1)
    top1, top5 = float(hit1.sum() / n), float(hit5.sum() / n)
    LOGGER.info(f"top1 {top1:.4f} top5 {top5:.4f} over {len(labels)} images")
    if verbose:
        for i, cname in enumerate(ds.classes):
            c_n = int((labels == i).sum())
            acc = hit1[labels == i].sum() / max(c_n, 1)
            LOGGER.info(f"  {cname:>20s}: {c_n:4d} imgs  top1 {acc:.4f}")
    return top1, top5


run.logits = None


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Classification validation (PyTorch port)")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--model", type=str, default="yolov5n.yaml")
    p.add_argument("--data-dir", "--data", type=str, required=True)
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=224)
    p.add_argument("--verbose", action="store_true", help="per-class accuracy")
    p.add_argument("--plots", action="store_true", help="save the val_images.jpg mosaic")
    p.add_argument("--save-dir", type=str, default=".")
    p.add_argument("--half", action="store_true", help="parity flag")
    p.add_argument("--dnn", action="store_true", help="parity flag")
    p.add_argument("--workers", type=int, default=0, help="parity flag")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--cutoff", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


def main(argv=None):
    return run(**vars(parse_opt(argv)))


if __name__ == "__main__":
    main()
