"""Pairing of two runs' detections of one model (the rows [x1, y1, x2, y2,
conf, cls, ...] that NMS keeps), for the port's tests and chip_smoke.py:
`match_detections` gives the share of one run's rows that the other holds,
`pair_detections` pairs them within stated tolerances and names the rows left
over. Neither is on a serving path."""

from __future__ import annotations

import numpy as np
import torch

from yolo_dual_tpu_torch.ops.boxes import box_iou


def match_detections(want: np.ndarray, got: np.ndarray, iou_min: float = 0.99,
                     conf_tol: float = 1e-4) -> float:
    """Share of the `want` detection rows [x1, y1, x2, y2, conf, cls, ...] that
    have a `got` row of the same class, IoU > iou_min (or corners within
    1e-3 px) and a confidence within conf_tol. Compares two runs of the same
    model whose near-tied candidates may be ordered differently."""
    if len(want) == 0:
        return 1.0
    if len(got) == 0:
        return 0.0
    iou = box_iou(torch.tensor(want[:, :4], dtype=torch.float64),
                  torch.tensor(got[:, :4], dtype=torch.float64)).numpy()
    # coinciding corners also match: a zero-area box has IoU 0 with itself
    same = (iou > iou_min) | (np.abs(want[:, None, :4] - got[None, :, :4]).max(-1) < 1e-3)
    ok = same & (want[:, None, 5] == got[None, :, 5]) & \
        (np.abs(want[:, None, 4] - got[None, :, 4]) < conf_tol)
    return float(ok.any(1).mean())


def pair_detections(want: np.ndarray, got: np.ndarray, conf_thres: float, iou_thres: float = 0.45,
                    box_tol: float = 1e-3, conf_tol: float = 1e-5, near: float = 1e-4):
    """Pair the rows [x1, y1, x2, y2, conf, cls, ...] of two runs' NMS outputs
    of one image: the same class, corners within `box_tol` px, confidences
    within `conf_tol`. A row left unpaired is a near tie when its confidence
    lies within `near` of `conf_thres`, or when it and a left row of the other
    run share a class, overlap past `iou_thres` and lie within `near` in
    confidence: NMS kept one of two near-tied boxes in each run. Returns
    (pairs, near ties, want rows left, got rows left); both lists are empty
    when the runs agree."""
    used = np.zeros(len(got), bool)
    left_w = []
    for i, row in enumerate(want):
        hit = np.flatnonzero(~used & (got[:, 5] == row[5])
                             & (np.abs(got[:, 4] - row[4]) <= conf_tol)
                             & (np.abs(got[:, :4] - row[:4]).max(1, initial=0) <= box_tol))
        if len(hit):
            used[hit[0]] = True
        else:
            left_w.append(i)
    left_g = [j for j in np.flatnonzero(~used) if abs(got[j, 4] - conf_thres) >= near]
    ties = int((~used).sum()) - len(left_g)
    for i in list(left_w):
        if abs(want[i, 4] - conf_thres) < near:
            left_w.remove(i)
            ties += 1
            continue
        for j in left_g:
            iou = box_iou(torch.tensor(want[i:i + 1, :4], dtype=torch.float64),
                          torch.tensor(got[j:j + 1, :4], dtype=torch.float64)).item()
            if got[j, 5] == want[i, 5] and abs(got[j, 4] - want[i, 4]) < near and iou > iou_thres:
                left_g.remove(j)
                left_w.remove(i)
                ties += 2
                break
    return int(used.sum()), ties, want[left_w], got[left_g]
