"""Box coordinate ops (port of yolo_dual_tpu/ops/boxes.py; reference
utils/general.py:752-884)."""

from __future__ import annotations

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4+) center-xywh -> corner-xyxy; columns past 4 pass through."""
    xy, wh = x[..., :2], x[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2, x[..., 4:]], -1)


def clip_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to image shape (h, w)."""
    h, w = shape[:2]
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], -1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy boxes from letterboxed img1_shape back to img0_shape
    (reference utils/general.py:829-843)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (img1_shape[1] - img0_shape[1] * gain) / 2, (img1_shape[0] - img0_shape[0] * gain) / 2
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    boxes = boxes - torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=boxes.dtype,
                                 device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)


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
