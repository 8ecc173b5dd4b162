"""Semantic-segmentation prediction CLI: frames -> colourised class masks and
alpha-blended overlays, and with --gt-json-dir [input | GT | pred | diff |
legend] panels plus mIoU and pixel accuracy (port of semantic/predict.py;
reference unet-lite/Resnet50/test.py:468+).

Usage:
    python -m yolo_dual_tpu_torch.semantic.predict --source DIR
    python -m yolo_dual_tpu_torch.semantic.predict --weights best.pt --source DIR \
        --gt-json-dir DIR --device cpu

`--source` is a frame or a directory of them: RGB uint8 `.npy` arrays, or
image files where cv2 is installed. Each frame is letterboxed on the host
(data/json_dataset.py:resize_and_pad, gray 128), as JAX's predictor does;
the forward and the argmax run on the device, one frame at a time. Outputs
are PNG where cv2 is installed, else `.npy`. Without --weights the model has
random weights drawn from a generator seeded with 0.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.data.json_dataset import _load_json_mask, read_frame, resize_and_pad
from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.metrics.seg import SegmentationConfusionMatrix
from yolo_dual_tpu_torch.models.model import SemanticSegModel
from yolo_dual_tpu_torch.semantic.val import CLASS_NAMES, save_image
from yolo_dual_tpu_torch.utils.general import LOGGER, Profile, increment_path, select_device
from yolo_dual_tpu_torch.utils.plots import CAMVID_PALETTE, colorize_semantic, semantic_panel

SUFFIXES = {".npy", ".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


def run(weights="", cfg="resnet50.json", source="", imgsz=640, nc=12, gt_json_dir="",
        alpha=0.5, names=None, project="runs/predict-semantic", name="exp", exist_ok=False,
        device="cuda", **kw):
    """Predict every frame of `source` (other keywords ignored, as JAX's run
    ignores them). Returns (metrics dict or None,
    save_dir, speed), speed = (pre, infer, post) ms a frame: pre the read,
    the host letterbox and the copy to the device; infer the forward and the
    argmax; post the copy back, the colouring and the writes."""
    dev = select_device(device)
    names = list(names) if names else CLASS_NAMES[:nc]
    model = SemanticSegModel(cfg, nc=nc, device=dev, generator=torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(resolve_state_dict(weights, model), strict=True)
    model.eval().fuse()
    src = Path(source)
    files = sorted(p for p in (src.iterdir() if src.is_dir() else [src])
                   if p.suffix.lower() in SUFFIXES)
    if not files:
        raise FileNotFoundError(f"no frames under {source}")
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    cm = SegmentationConfusionMatrix(nc, ignore_index=nc - 1) if gt_json_dir else None
    dt = tuple(Profile(device=dev) for _ in range(3))
    for f in files:
        with dt[0]:
            padded, _, _ = resize_and_pad(read_frame(f), None, imgsz)
            x = normalize_image(torch.from_numpy(padded).to(dev)[None].permute(0, 3, 1, 2))
        with dt[1], torch.inference_mode():
            pred = model(x.contiguous()).argmax(1)
        with dt[2]:
            pred = pred[0].cpu().numpy()
            pred_rgb = colorize_semantic(pred, CAMVID_PALETTE)
            overlay = (padded.astype(np.float32) * (1 - alpha)
                       + pred_rgb.astype(np.float32) * alpha).astype(np.uint8)
            save_image(save_dir / f"{f.stem}_mask", pred_rgb)
            save_image(save_dir / f"{f.stem}_overlay", overlay)
            if cm is not None:
                gt = _load_json_mask(Path(gt_json_dir) / f"{f.stem}.json")
                _, gt_p, _ = resize_and_pad(np.zeros((*gt.shape, 3), np.uint8), gt, imgsz,
                                            mask_fill=nc - 1)
                cm.update(pred, gt_p)
                save_image(save_dir / f"{f.stem}_panel",
                           semantic_panel(padded, gt_p, pred, names=names))
    speed = tuple(t.t / len(files) * 1e3 for t in dt)
    LOGGER.info(f"{len(files)} images -> {save_dir}; speed: {speed[0]:.1f}ms pre, "
                f"{speed[1]:.1f}ms inference, {speed[2]:.1f}ms post per image")
    if cm is None:
        return None, save_dir, speed
    m = cm.get_metrics()
    LOGGER.info(f"mIoU {m['mIoU']:.4f}  pixel-acc {m['Accuracy']:.4f}")
    for i, n in enumerate(names):
        LOGGER.info(f"  {n:>12s}: IoU {m['IoU'][i]:.4f}  acc {m['Class_Accuracy'][i]:.4f}")
    return m, save_dir, speed


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, default="", help="a .pt state_dict or an orbax checkpoint directory of the JAX package")
    p.add_argument("--cfg", type=str, default="resnet50.json")
    p.add_argument("--source", type=str, required=True, help="frame file or directory")
    p.add_argument("--imgsz", "--img-size", type=int, default=640)
    p.add_argument("--nc", type=int, default=12)
    p.add_argument("--gt-json-dir", type=str, default="",
                   help="JSON masks for panels and mIoU / pixel accuracy")
    p.add_argument("--alpha", type=float, default=0.5, help="overlay blend weight")
    p.add_argument("--project", default="runs/predict-semantic")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(**vars(parse_opt()))
