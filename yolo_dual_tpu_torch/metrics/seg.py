"""Instance-segmentation metrics: box + mask mAP accumulators and the TP
matching (port of yolo_dual_tpu/metrics/seg.py; reference
utils/segment/metrics.py:11-210, segment/val.py:91-125).

The AP accumulators are host numpy. `match_predictions_device` is the
validator's matching in torch, batched over images and IoU thresholds where
the JAX package vmaps; `match_predictions` is the reference's numpy rule it
is held against. `SegmentationConfusionMatrix` is the semantic path's
pixel confusion matrix and mIoU, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_dual_tpu_torch.metrics.ap import ap_per_class

IOUV = np.linspace(0.5, 0.95, 10)


def fitness_seg(x: np.ndarray) -> float:
    """8-way fitness w=[.0,.0,.1,.9,.0,.0,.1,.9] over box+mask metric rows."""
    w = [0.0, 0.0, 0.1, 0.9, 0.0, 0.0, 0.1, 0.9]
    return (np.asarray(x)[:8] * w).sum()


def ap_per_class_box_and_mask(tp_b, tp_m, conf, pred_cls, target_cls,
                              plot=False, save_dir=".", names=()):
    """Two ap_per_class passes, packaged (reference utils/segment/metrics.py:17-63)."""
    results_box = ap_per_class(tp_b, conf, pred_cls, target_cls, plot=plot,
                               save_dir=save_dir, names=names, prefix="Box")[2:]
    results_mask = ap_per_class(tp_m, conf, pred_cls, target_cls, plot=plot,
                                save_dir=save_dir, names=names, prefix="Mask")[2:]
    return {
        "boxes": {"p": results_box[0], "r": results_box[1], "f1": results_box[2],
                  "ap": results_box[3], "ap_class_index": results_box[4]},
        "masks": {"p": results_mask[0], "r": results_mask[1], "f1": results_mask[2],
                  "ap": results_mask[3], "ap_class_index": results_mask[4]},
    }


class Metric:
    """Per-task accumulator (reference utils/segment/metrics.py:66-150)."""

    def __init__(self):
        self.p = []
        self.r = []
        self.f1 = []
        self.all_ap = []
        self.ap_class_index = []

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return (self.mp, self.mr, self.map50, self.map)

    def class_result(self, i):
        return (self.p[i], self.r[i], self.ap50[i], self.ap[i])

    def get_maps(self, nc):
        maps = np.zeros(nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[c] = self.ap[i]
        return maps

    def update(self, results):
        self.p, self.r, self.f1, self.all_ap, self.ap_class_index = \
            results["p"], results["r"], results["f1"], results["ap"], results["ap_class_index"]


class Metrics:
    """Box + mask metric pair (reference utils/segment/metrics.py:153-210)."""

    def __init__(self):
        self.metric_box = Metric()
        self.metric_mask = Metric()

    def update(self, results):
        self.metric_box.update(results["boxes"])
        self.metric_mask.update(results["masks"])

    def mean_results(self):
        return self.metric_box.mean_results() + self.metric_mask.mean_results()

    def class_result(self, i):
        return self.metric_box.class_result(i) + self.metric_mask.class_result(i)

    def get_maps(self, nc):
        return self.metric_box.get_maps(nc) + self.metric_mask.get_maps(nc)

    @property
    def ap_class_index(self):
        return self.metric_box.ap_class_index


def match_predictions(pred_cls, gt_cls, iou, iouv=IOUV):
    """TP matrix at the 10 IoU thresholds (reference segment/val.py:91-125
    process_batch matching rules: greedy by IoU with per-gt/per-pred dedup).
    pred_cls (D,), gt_cls (M,), iou (M, D) numpy. Returns (D, T) bool."""
    correct = np.zeros((pred_cls.shape[0], len(iouv)), bool)
    cls_ok = gt_cls[:, None] == pred_cls[None, :]
    iou = np.where(cls_ok, iou, 0.0)
    for i, t in enumerate(iouv):
        x = np.argwhere(iou >= t)
        if x.shape[0]:
            matches = np.concatenate((x, iou[x[:, 0], x[:, 1]][:, None]), 1)
            if x.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def match_predictions_device(pred_cls: torch.Tensor, gt_cls: torch.Tensor, iou: torch.Tensor,
                             iouv=None) -> torch.Tensor:
    """Torch formulation of `match_predictions`, batched over any leading
    dims and over the thresholds at once: per threshold t, each det picks its
    highest-IoU class-matched gt with iou ≥ t (the first on ties), then each
    gt keeps the LOWEST-INDEX det among its claimants (dets are NMS-ordered
    by confidence, and the reference's unique-by-gt runs on a det-index
    ordered array, segment/val.py:117-121). Equal to the numpy version up to
    IoU ties.

    pred_cls (..., D), gt_cls (..., M), iou (..., M, D) pre-masked to valid
    rows/cols. Returns (..., D, T) bool."""
    thr = torch.as_tensor(IOUV if iouv is None else iouv, dtype=torch.float32,
                          device=iou.device)
    m, d = iou.shape[-2:]
    iou = torch.where(gt_cls[..., :, None] == pred_cls[..., None, :], iou, 0.0)
    v = torch.where(iou[..., None, :, :] >= thr[:, None, None], iou[..., None, :, :], 0.0)
    best_gt = v.argmax(-2)                                                   # (..., T, D)
    det_has = v.amax(-2) > 0
    sel = (best_gt[..., None, :] == torch.arange(m, device=iou.device)[:, None]) \
        & det_has[..., None, :]                                              # (..., T, M, D)
    win_det = torch.where(sel, torch.arange(d, device=iou.device), d).amin(-1)  # (..., T, M)
    correct = torch.zeros((*win_det.shape[:-1], d + 1), dtype=torch.bool, device=iou.device)
    correct.scatter_(-1, win_det, True)                    # a gt without claimant writes column d
    return correct[..., :d].transpose(-1, -2)


class SegmentationConfusionMatrix:
    """Semantic-seg confusion matrix (rows: target, columns: prediction) with
    per-class IoU and an mIoU that skips `ignore_index` (JAX
    metrics/seg.py:168; reference unet-lite/Resnet50/val_diceloss.py:69-118)."""

    def __init__(self, nc: int, ignore_index: int = None):
        self.nc = nc
        self.ignore_index = ignore_index
        self.matrix = np.zeros((nc, nc), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        """pred / target: integer class ids of one shape; targets outside
        [0, nc) are dropped, predictions clipped into it."""
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        keep = (target >= 0) & (target < self.nc)
        pred = np.clip(pred[keep], 0, self.nc - 1)
        idx = target[keep] * self.nc + pred
        self.matrix += np.bincount(idx, minlength=self.nc ** 2).reshape(self.nc, self.nc)

    def compute_iou(self):
        """(mIoU over the classes other than ignore_index that occur, per-class
        IoU with NaN where a class is neither predicted nor present)."""
        tp = np.diag(self.matrix).astype(np.float64)
        fp = self.matrix.sum(0) - tp
        fn = self.matrix.sum(1) - tp
        denom = tp + fp + fn
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
        classes = np.arange(self.nc)
        if self.ignore_index is not None:
            classes = classes[classes != self.ignore_index]
        valid = iou[classes]
        miou = np.nanmean(valid) if np.isfinite(valid).any() else 0.0
        return miou, iou

    def pixel_accuracy(self):
        return np.diag(self.matrix).sum() / max(self.matrix.sum(), 1)

    def class_accuracy(self):
        """Per-class recall, diag / row sum (reference test.py:455-458)."""
        row = self.matrix.sum(1).astype(np.float64)
        return np.diag(self.matrix) / np.maximum(row, 1)

    def get_metrics(self):
        """{"mIoU", "IoU", "Accuracy", "Class_Accuracy"} (reference test.py:436-464)."""
        miou, iou = self.compute_iou()
        return {"mIoU": miou, "IoU": iou, "Accuracy": self.pixel_accuracy(),
                "Class_Accuracy": self.class_accuracy()}

    def reset(self):
        self.matrix[:] = 0
