"""Mask post-processing (port of yolo_dual_tpu/ops/mask_ops.py; reference
utils/segment/general.py:7-95). Protos are NCHW: (c, mh, mw) per image."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each box. masks (n, h, w), boxes (n, 4) xyxy
    in mask-pixel coords (reference utils/segment/general.py:7-22)."""
    n, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None, None].unbind(1)                      # each (n, 1, 1)
    r = torch.arange(w, device=masks.device, dtype=boxes.dtype)[None, None, :]
    c = torch.arange(h, device=masks.device, dtype=boxes.dtype)[None, :, None]
    keep = (r >= x1) & (r < x2) & (c >= y1) & (c < y2)
    return masks * keep


def process_mask(protos: torch.Tensor, masks_in: torch.Tensor, bboxes: torch.Tensor,
                 shape, upsample: bool = False, binarize: bool = True) -> torch.Tensor:
    """Crop-then-(optionally)-upsample (reference utils/segment/general.py:43-67).

    protos: (c, mh, mw) for ONE image; masks_in: (n, c) NMS-kept coefficients;
    bboxes: (n, 4) xyxy in input-image pixels; shape: (ih, iw).
    Returns (n, h, w) float, or bool if binarize.
    """
    c, mh, mw = protos.shape
    ih, iw = shape
    masks = (masks_in @ protos.reshape(c, mh * mw)).sigmoid().view(-1, mh, mw)
    scale = torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih], dtype=bboxes.dtype,
                         device=bboxes.device)
    masks = crop_mask(masks, bboxes * scale)
    if upsample and (mh, mw) != (ih, iw):
        masks = F.interpolate(masks[None], size=(ih, iw), mode="bilinear", align_corners=False)[0]
    return masks > 0.5 if binarize else masks


def scale_image(im1_shape, masks: torch.Tensor, im0_shape, ratio_pad=None) -> torch.Tensor:
    """Un-letterbox masks (n, h, w) from the model input shape to the original
    image shape, on the masks' device (reference utils/segment/general.py:70-95).

    The resize is a bilinear `F.interpolate` with half-pixel centers. The JAX
    package and the reference resize with cv2.resize, whose fixed-point
    interpolation weights differ from this float resize in the low bits.
    """
    if ratio_pad is None:
        gain = min(im1_shape[0] / im0_shape[0], im1_shape[1] / im0_shape[1])
        pad = (im1_shape[1] - im0_shape[1] * gain) / 2, (im1_shape[0] - im0_shape[0] * gain) / 2
    else:
        pad = ratio_pad[1]
    top, left = int(pad[1]), int(pad[0])
    bottom, right = int(im1_shape[0] - pad[1]), int(im1_shape[1] - pad[0])
    if masks.ndim != 3:
        raise ValueError(f"masks must be (n, h, w), got shape {tuple(masks.shape)}")
    masks = masks[:, top:bottom, left:right].float()
    return F.interpolate(masks[None], size=tuple(im0_shape[:2]), mode="bilinear",
                         align_corners=False)[0]


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of flattened binary masks: (..., N, hw) x (..., M, hw) ->
    (..., N, M) (reference utils/segment/general.py:98-110)."""
    inter = (mask1 @ mask2.transpose(-1, -2)).clamp(min=0)
    union = mask1.sum(-1)[..., :, None] + mask2.sum(-1)[..., None, :] - inter
    return inter / (union + eps)


def masks_iou(mask1: torch.Tensor, mask2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of aligned masks (n, hw) (reference utils/segment/general.py:113-121)."""
    inter = (mask1 * mask2).sum(-1).clamp(min=0)
    union = mask1.sum(-1) + mask2.sum(-1) - inter
    return inter / (union + eps)
