"""Classification training CLI (port of classify/train.py; reference
classify/train.py:46-333).

    python -m yolo_dual_tpu_torch.classify.train --model yolov5s.yaml --data-dir DIR --epochs 10
    python -m yolo_dual_tpu_torch.classify.train --model resnet18 --data-dir DIR --device cpu

A YOLO-cls model (a detection config's first --cutoff layers and a Classify
head) or one of the twelve torchvision families (`TORCHVISION_ARCHS`: its
three stages and the head). The data directory holds `train/` and `val/` (or
`test/`), each a folder a class of image files (read with cv2) or RGB uint8
`.npy` frames (data/classify.py). Each epoch: the shuffled, augmented
training batches through the train step (smoothed cross-entropy, Adam with
a cosine schedule and no warmup epochs, the EMA); the EMA model's top-1 and
top-5 on the val set; a row of `results.csv` (epoch, train_loss, top1,
top5); `last.pt` and, when the top-1 is the best so far, `best.pt` (with
--nosave only at the last epoch); early stopping on the top-1.

The model starts from the JAX package's initial weights under
`PRNGKey(--seed)` (models/flax_init.py:flax_init_), as JAX's trainer does;
--pretrained with a local checkpoint then replaces the entries whose names
and shapes match. Dropout (--dropout) draws from a generator seeded for each
micro-step (train/trainer.py:Trainer.dropout), as JAX's trainer folds the step
into its key, but not JAX's stream. The device defaults to cuda; pass
--device cpu to run on the CPU.

--data-parallel under `python -m torch.distributed.run --nproc-per-node N -m
yolo_dual_tpu_torch.classify.train ...` trains one rank a process
(parallel/mesh.py): --batch-size is the global batch, each rank loads its
rows of it, BatchNorm and the cross-entropy's mean span the global batch.
Every rank scores the whole val set (the same numbers everywhere, so early
stopping agrees) and rank 0 alone writes the run directory.
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.data.classify import create_classification_dataloader
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.models.model import ClassificationModel
from yolo_dual_tpu_torch.parallel.mesh import (data_parallel, from_rank0, is_main, rank0_first,
                                               shard_loader)
from yolo_dual_tpu_torch.train.checkpoint import partial_load, save_checkpoint
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import smart_optimizer
from yolo_dual_tpu_torch.train.trainer import EarlyStopping, Trainer, classify_loss
from yolo_dual_tpu_torch.utils.general import (LOGGER, find_cfg, increment_path, init_seeds,
                                               select_device)

ROOT = Path(__file__).resolve().parents[2]
TORCHVISION_ARCHS = ("resnet18", "resnet34", "resnet50", "wide_resnet50_2",
                     "MobileNetV3s", "mobilenet_v2", "efficientnet_b0",
                     "efficientnet_b1", "efficientnet_v2_s", "RegNety400",
                     "vgg11_bn", "convnext_tiny")


def build_classifier(model_name, nc: int, cutoff: int = 10, dropout: float = 0.0,
                     device="cuda", generator=None) -> ClassificationModel:
    """YOLO-cls (a detection config, a path or a JSON copy's name, cut at
    `cutoff`) or a torchvision family (its stages `[<arch>1, <arch>2,
    <arch>3]`, c2 0, cutoff 3) with a Classify head of `nc` classes."""
    if model_name in TORCHVISION_ARCHS:
        cfg = dict(nc=nc, depth_multiple=1.0, width_multiple=1.0,
                   backbone=[[-1, 1, f"{model_name}{i}", [0]] for i in (1, 2, 3)], head=[])
        return ClassificationModel(cfg, nc=nc, cutoff=3, dropout=dropout, device=device,
                                   generator=generator)
    cfg = model_name if isinstance(model_name, dict) else find_cfg(model_name)
    return ClassificationModel(cfg, nc=nc, cutoff=cutoff, dropout=dropout, device=device,
                               generator=generator)


def topk_hits(logits: np.ndarray, labels: np.ndarray):
    """(top-1 hits, top-5 hits) of each row: the label first in the logits'
    descending order, or among the first five."""
    order = np.argsort(-logits, axis=1)
    return order[:, 0] == labels, (order[:, :5] == labels[:, None]).any(1)


def train(opt):
    """Train as JAX classify/train.py:train does; returns the best top-1."""
    mesh = data_parallel(opt.device) if opt.data_parallel else None
    rank0 = is_main(mesh)
    dev = select_device(opt.device)
    init_seeds(opt.seed)
    save_dir = from_rank0(lambda: increment_path(Path(opt.project) / opt.name,
                                                 exist_ok=opt.exist_ok, mkdir=True), mesh)
    data = Path(opt.data_dir)
    with rank0_first(mesh):  # a disk cache is written once
        train_loader, train_ds = create_classification_dataloader(
            data / "train", imgsz=opt.imgsz, batch_size=opt.batch_size,
            augment=not opt.no_augment, cache=opt.cache, shuffle=True, seed=opt.seed)
        val_loader, _ = create_classification_dataloader(
            data / ("val" if (data / "val").exists() else "test"), imgsz=opt.imgsz,
            batch_size=opt.batch_size, augment=False, cache=opt.cache, shuffle=False)
    shard_loader(train_loader, mesh)
    nc = len(train_ds.classes)

    model = build_classifier(opt.model, nc, cutoff=opt.cutoff, dropout=opt.dropout or 0.0,
                             device=dev)
    flax_init_(model, seed=opt.seed)
    if opt.pretrained:
        if Path(opt.pretrained).exists():
            partial_load(model, opt.pretrained)
        else:
            LOGGER.info("--pretrained: no local weights file given; torchvision release "
                        "downloads need the network - training from scratch")
    hyp = dict(lr0=opt.lr0, lrf=opt.lrf, momentum=0.9, weight_decay=opt.decay,
               warmup_epochs=0.0)
    optimizer = smart_optimizer(model, opt.optimizer, hyp, epochs=opt.epochs,
                                steps_per_epoch=len(train_loader), cos_lr=True)
    trainer = Trainer(model, lambda logits, labels: classify_loss(logits, labels,
                                                                   opt.label_smoothing),
                      optimizer, ema=ModelEMA(model, decay=0.9999, tau=2000.0), task="classify",
                      dropout=bool(opt.dropout), mesh=mesh)
    state = trainer.init_state()
    stopper = EarlyStopping(opt.patience)
    best = 0.0
    csv_path = save_dir / "results.csv"
    if rank0:
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerow(["epoch", "train_loss", "top1", "top5"])
    t0 = time.time()
    for epoch in range(opt.epochs):
        train_loader.set_epoch(epoch)
        mloss = 0.0
        for i, batch in enumerate(train_loader):
            state, m = trainer.train_step(state, {"image": batch["image"],
                                                  "label": batch["label"]})
            mloss = (mloss * i + float(m["loss"])) / (i + 1)
        top1 = top5 = n = 0
        for batch in val_loader:
            logits = trainer.eval_step(state, {"image": batch["image"]}).float().cpu().numpy()
            bsz = int(batch["n_valid"])
            hit1, hit5 = topk_hits(logits[:bsz], batch["label"][:bsz])
            top1, top5, n = top1 + hit1.sum(), top5 + hit5.sum(), n + bsz
        top1, top5 = float(top1 / max(n, 1)), float(top5 / max(n, 1))
        LOGGER.info(f"epoch {epoch}: loss {mloss:.4f} top1 {top1:.4f} top5 {top5:.4f} "
                    f"({(time.time() - t0) / (epoch + 1):.1f}s/epoch)")
        if rank0:
            with open(csv_path, "a", newline="") as f:
                csv.writer(f).writerow([epoch, mloss, top1, top5])
        if rank0 and (not opt.nosave or epoch == opt.epochs - 1):
            ckpt = {"model": state.model.state_dict(), "ema": state.ema.ema.state_dict(),
                    "updates": state.ema.updates, "epoch": epoch, "best_fitness": max(best, top1),
                    "classes": list(train_ds.classes)}
            save_checkpoint(save_dir / "last.pt", ckpt)
            if top1 >= best:
                save_checkpoint(save_dir / "best.pt", ckpt)
        best = max(best, top1)
        if stopper(epoch, top1):
            break
    LOGGER.info(f"Done; best top1 {best:.4f}; results in {save_dir}")
    return best


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Classification training (PyTorch port)")
    p.add_argument("--model", type=str, default="yolov5n.yaml",
                   help="detection cfg for the backbone, or a torchvision arch name "
                        "(resnet18, efficientnet_b0, ...)")
    p.add_argument("--data-dir", "--data", type=str, required=True,
                   help="root with train/ and val|test/")
    p.add_argument("--cutoff", type=int, default=10)
    p.add_argument("--cache", type=str, default=False, nargs="?", const="ram",
                   help="image cache: ram or disk (reference --cache)")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=224)
    p.add_argument("--dropout", type=float, default=None, help="classifier-head dropout fraction")
    p.add_argument("--pretrained", type=str, default="", nargs="?", const="download",
                   help="a local checkpoint to start from (torchvision downloads need the "
                        "network, and without a file the run trains from scratch)")
    p.add_argument("--nosave", action="store_true", help="checkpoint final epoch only")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--workers", type=int, default=0,
                   help="accepted for parity (one prefetch thread reads the samples)")
    p.add_argument("--optimizer", default="Adam")
    p.add_argument("--lr0", type=float, default=0.001)
    p.add_argument("--lrf", type=float, default=0.01)
    p.add_argument("--decay", type=float, default=5e-5)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--project", default=str(ROOT / "runs" / "train-cls"))
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank a process under torch.distributed.run; --batch-size is global")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


def main(argv=None):
    return train(parse_opt(argv))


if __name__ == "__main__":
    main()
