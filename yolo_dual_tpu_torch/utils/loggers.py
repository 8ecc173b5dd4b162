"""Training observability: results.csv, TensorBoard and the remote sinks
(port of yolo_dual_tpu/utils/loggers.py; reference utils/loggers/__init__.py).

TensorBoard events are written through torch.utils.tensorboard where the
`tensorboard` package is installed (JAX's go through tensorflow's summary
writer); without it the TB sink does nothing and says so once in the log.
The remote sinks (utils/remote_loggers.py) are no-ops without their SDKs.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from yolo_dual_tpu_torch.utils.general import LOGGER


class _TBWriter:
    def __init__(self, log_dir):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:  # torch.utils.tensorboard needs the tensorboard package
            LOGGER.info(f"TensorBoard logging disabled: {e}")
            return
        self.writer = SummaryWriter(str(log_dir))

    def scalar(self, tag, value, step):
        if self.writer:
            self.writer.add_scalar(tag, float(value), int(step))

    def image(self, tag, img_hwc_uint8, step):
        if self.writer:
            self.writer.add_image(tag, np.asarray(img_hwc_uint8), int(step), dataformats="HWC")

    def flush(self):
        if self.writer:
            self.writer.flush()

    def close(self):
        if self.writer:
            self.writer.close()


# Per-epoch metric keys of the segment trainer (reference utils/loggers/__init__.py:67-81)
SEG_KEYS = [
    "train/box_loss", "train/seg_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP_0.5(B)", "metrics/mAP_0.5:0.95(B)",
    "metrics/precision(M)", "metrics/recall(M)", "metrics/mAP_0.5(M)", "metrics/mAP_0.5:0.95(M)",
    "x/lr0", "x/lr1", "x/lr2",
]


class Loggers:
    """CSV + TB + optional remote sinks (W&B, ClearML, Comet), driven by the
    reference Loggers facade's named hooks.

    Resume-safe: where results.csv exists its header is adopted and rows are
    appended to it instead of truncating the history."""

    def __init__(self, save_dir, opt=None, hyp=None, include=("csv", "tb"), run_name=None):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.save_dir / "results.csv"
        self.csv = "csv" in include
        self.keys: Optional[list] = None
        if self.csv_path.exists():
            try:
                with open(self.csv_path) as f:
                    header = f.readline().strip()
                if header:
                    self.keys = header.split(",")
            except OSError:
                pass
        self.tb = _TBWriter(self.save_dir) if "tb" in include else None
        from yolo_dual_tpu_torch.utils.remote_loggers import ADAPTERS, build_remote_loggers
        self.remote = build_remote_loggers(
            [n for n in include if n in ADAPTERS],
            run_name=run_name, config={"opt": opt, "hyp": hyp}, save_dir=save_dir)
        self.wandb = next((r for r in self.remote if type(r).__name__ == "WandbLogger"
                           and r.active), None)

    def log_metrics(self, metrics: Dict[str, float], step: int):
        if self.csv:
            if self.keys is None:
                self.keys = ["step"] + list(metrics)
                with open(self.csv_path, "w", newline="") as f:
                    csv.writer(f).writerow(self.keys)
            with open(self.csv_path, "a", newline="") as f:
                csv.writer(f).writerow([step] + [float(metrics.get(k, np.nan))
                                                 for k in self.keys[1:]])
        if self.tb:
            for k, v in metrics.items():
                self.tb.scalar(k, v, step)
            self.tb.flush()
        for r in self.remote:
            r.log_metrics(metrics, step)

    def log_images(self, tag: str, image_hwc_uint8: np.ndarray, step: int):
        if self.tb:
            self.tb.image(tag, image_hwc_uint8, step)
        for r in self.remote:
            r.log_image(tag, image_hwc_uint8, step)

    def log_model(self, path, epoch: int = 0, best: bool = False):
        """Checkpoint upload hook (reference on_model_save)."""
        for r in self.remote:
            r.log_model(path, epoch=epoch, best=best)

    def log_artifact(self, path, type: str = "dataset", name: Optional[str] = None):
        for r in self.remote:
            r.log_artifact(path, type=type, name=name)

    # --- the reference's named hooks (utils/loggers/__init__.py) ----------
    def on_fit_epoch_end(self, vals, epoch: int, keys: Optional[list] = None):
        self.log_metrics(dict(zip(keys or SEG_KEYS, [float(v) for v in vals])), epoch)

    def on_model_save(self, last_path, epoch: int, best_fitness: float, fi: float):
        self.log_model(last_path, epoch=epoch, best=fi >= best_fitness)

    def on_train_end(self, results_png=None):
        if results_png is not None and Path(str(results_png)).exists():
            import cv2
            img = cv2.imread(str(results_png))
            if img is not None:
                self.log_images("results", img[..., ::-1], 0)
        self.close()

    def close(self):
        if self.tb:
            self.tb.close()
        for r in self.remote:
            r.finish()


class GenericLogger(Loggers):
    """The classification trainer's logger (reference utils/loggers/__init__.py
    GenericLogger): the same sinks, any keys."""

    def log_graph(self, *a, **k):
        pass
