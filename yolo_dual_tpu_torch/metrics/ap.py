"""Detection metrics: AP curves, confusion matrix, fitness (port of
yolo_dual_tpu/metrics/ap.py; reference utils/metrics.py:17-222).

Host numpy: they aggregate over a whole evaluation. `plot=True` draws the
PR, F1, P and R curves with matplotlib (utils/plots.py) and raises without it,
as JAX's does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.ops.boxes import box_iou


def fitness(x: np.ndarray) -> np.ndarray:
    """Weighted combination [P, R, mAP@.5, mAP@.5:.95] @ w=[0,0,0.1,0.9]."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (np.asarray(x)[:, :4] * w).sum(1)


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter of fraction f over y, edges padded with the end values."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """101-point interpolated AP (COCO style)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, plot=False, save_dir=".",
                 names=(), eps=1e-16, prefix=""):
    """Per-class AP from accumulated predictions.

    tp: (n, niou) bool; conf: (n,); pred_cls: (n,); target_cls: (m,).
    Returns tp, fp, p, r, f1, ap (nc, niou), unique_classes.
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    py = []
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    if plot:
        from yolo_dual_tpu_torch.utils.plots import plot_mc_curve, plot_pr_curve
        names = dict(enumerate(v for k, v in dict(names).items() if k in unique_classes))
        plot_pr_curve(px, py, ap, Path(save_dir) / f"{prefix}PR_curve.png", names)
        for curve, tag, label in ((f1, "F1", "F1"), (p_curve, "P", "Precision"),
                                  (r_curve, "R", "Recall")):
            plot_mc_curve(px, curve, Path(save_dir) / f"{prefix}{tag}_curve.png", names,
                          ylabel=label)
    i = smooth(f1.mean(0), 0.1).argmax()
    p, r, f1v = p_curve[:, i], r_curve[:, i], f1[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return tp_count, fp_count, p, r, f1v, ap, unique_classes.astype(int)


class ConfusionMatrix:
    """Detection confusion matrix (reference utils/metrics.py:126-222)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        """detections (n, 6+) [x1,y1,x2,y2,conf,cls]; labels (m, 5) [cls, xyxy]."""
        if detections is None or len(detections) == 0:
            for gc in (labels[:, 0].astype(int) if len(labels) else []):
                self.matrix[self.nc, gc] += 1
            return
        detections = np.asarray(detections)
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if len(labels) else np.zeros(0, int)
        det_classes = detections[:, 5].astype(int)
        if len(labels):
            iou = box_iou(torch.as_tensor(labels[:, 1:5], dtype=torch.float32),
                          torch.as_tensor(detections[:, :4], dtype=torch.float32)).numpy()
            x = np.argwhere(iou > self.iou_thres)
            if x.shape[0]:
                matches = np.concatenate((x, iou[x[:, 0], x[:, 1]][:, None]), 1)
                if x.shape[0] > 1:
                    matches = matches[matches[:, 2].argsort()[::-1]]
                    matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                    matches = matches[matches[:, 2].argsort()[::-1]]
                    matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            else:
                matches = np.zeros((0, 3))
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not any(m1 == i):
                    self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]

    def print(self):
        for row in self.matrix:
            print(" ".join(f"{v:.0f}" for v in row))

