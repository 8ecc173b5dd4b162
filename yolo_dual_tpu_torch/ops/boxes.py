"""Box coordinate ops (port of yolo_dual_tpu/ops/boxes.py; reference
utils/general.py:752-884)."""

from __future__ import annotations

import math

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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, SIoU: bool = False, EIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of aligned boxes (..., 4) -> (..., 1), with GIoU, DIoU,
    CIoU (reference utils/metrics.py:225-263) or SIoU, EIoU (reference
    utils/general-softnms.py:881-936); JAX ops/boxes.py:bbox_iou. CIoU's
    `alpha` carries no gradient, as in the reference."""
    if xywh:
        (x1, y1, w1, h1), (x2, y2, w2, h2) = box1.chunk(4, -1), box2.chunk(4, -1)
        w1_, h1_, w2_, h2_ = w1 / 2, h1 / 2, w2 / 2, h2 / 2
        b1x1, b1x2, b1y1, b1y2 = x1 - w1_, x1 + w1_, y1 - h1_, y1 + h1_
        b2x1, b2x2, b2y1, b2y2 = x2 - w2_, x2 + w2_, y2 - h2_, y2 + h2_
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.chunk(4, -1)
        b2x1, b2y1, b2x2, b2y2 = box2.chunk(4, -1)

    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * \
        (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    union = (b1x2 - b1x1) * (b1y2 - b1y1) + (b2x2 - b2x1) * (b2y2 - b2y1) - inter + eps
    iou = inter / union
    if not (CIoU or DIoU or GIoU or SIoU or EIoU):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    w1c, h1c = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2c, h2c = b2x2 - b2x1, b2y2 - b2y1 + eps
    if CIoU or DIoU or EIoU:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi ** 2) * (torch.atan(w2c / h2c) - torch.atan(w1c / h1c)) ** 2
            with torch.no_grad():
                alpha = v / (v - iou + (1 + eps))
            return iou - (rho2 / c2 + v * alpha)
        if EIoU:
            return iou - (rho2 / c2 + (w2c - w1c) ** 2 / (cw ** 2 + eps)
                          + (h2c - h1c) ** 2 / (ch ** 2 + eps))
        return iou - rho2 / c2  # DIoU
    if SIoU:  # SCYLLA-IoU (reference utils/general-softnms.py:899-917)
        s_cw = (b2x1 + b2x2 - b1x1 - b1x2) * 0.5
        s_ch = (b2y1 + b2y2 - b1y1 - b1y2) * 0.5
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + eps
        sin_a, sin_b = s_cw.abs() / sigma, s_ch.abs() / sigma
        sin_best = torch.where(sin_a > math.sqrt(2) / 2, sin_b, sin_a)
        gamma = torch.cos(torch.arcsin(sin_best) * 2 - math.pi / 2) - 2
        rho_x = ((b2x1 + b2x2 - b1x1 - b1x2) / (2 * cw + eps)) ** 2
        rho_y = ((b2y1 + b2y2 - b1y1 - b1y2) / (2 * ch + eps)) ** 2
        dist_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omega_w = (w1c - w2c).abs() / torch.maximum(w1c, w2c)
        omega_h = (h1c - h2c).abs() / torch.maximum(h1c, h2c)
        shape_cost = (1 - torch.exp(-omega_w)) ** 4 + (1 - torch.exp(-omega_h)) ** 4
        return iou - 0.5 * (dist_cost + shape_cost)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area  # GIoU

