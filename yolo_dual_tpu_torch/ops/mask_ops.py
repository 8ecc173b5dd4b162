"""Mask post-processing (port of yolo_dual_tpu/ops/mask_ops.py; reference
utils/segment/general.py:7-137). Protos are NCHW: (c, mh, mw) per image."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from yolo_dual_tpu_torch.ops.contours import find_external_contours


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
    if upsample:
        masks = _resize_masks_bilinear(masks, shape)
    return masks > 0.5 if binarize else masks


def _resize_masks_bilinear(masks: torch.Tensor, shape) -> torch.Tensor:
    """(n, h, w) -> (n, *shape), half-pixel bilinear, antialiased when it
    shrinks, as jax.image.resize(method="bilinear")."""
    if tuple(masks.shape[-2:]) == tuple(shape):
        return masks
    shrink = shape[0] < masks.shape[-2] or shape[1] < masks.shape[-1]
    return F.interpolate(masks[None], size=tuple(shape), mode="bilinear", align_corners=False,
                         antialias=shrink)[0]


def process_mask_upsample(protos: torch.Tensor, masks_in: torch.Tensor, bboxes: torch.Tensor,
                          shape, binarize: bool = True) -> torch.Tensor:
    """Upsample-then-crop (reference utils/segment/general.py:25-40): the
    masks at proto resolution resized to `shape` (ih, iw), then cropped to
    `bboxes` (n, 4) xyxy in input-image pixels. Returns (n, ih, iw) float, or
    bool if binarize."""
    c, mh, mw = protos.shape
    masks = (masks_in @ protos.reshape(c, mh * mw)).sigmoid().view(-1, mh, mw)
    masks = crop_mask(_resize_masks_bilinear(masks, shape), bboxes)
    return masks > 0.5 if binarize else masks


def _linear_taps(n_in: int, n_out: int, clamp: bool, device):
    """cv2's INTER_LINEAR taps along one axis (imgproc/resize.cpp): the source
    coordinate (d + 0.5) * scale - 0.5 rounded to float32, its floor and
    fraction in float32, weights 1 - f and f. Horizontally (`clamp`) a tap
    left of the first or right of the last pixel takes that pixel with weight
    1; vertically the fraction stands and both rows are clamped."""
    d = np.arange(n_out)
    f = ((d + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i).astype(np.float32)
    if clamp:
        f[(i < 0) | (i >= n_in - 1)] = 0
        i = np.clip(i, 0, n_in - 1)
    i0, i1 = np.clip(i, 0, n_in - 1), np.clip(i + 1, 0, n_in - 1)
    w0, w1 = np.float32(1) - f, f
    return [torch.from_numpy(a).to(device) for a in (i0, i1, w0, w1)]


def resize_linear_f32(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """cv2.resize(img, (nw, nh), interpolation=INTER_LINEAR) of float32
    images, on the last two axes of `x` (..., h, w), in OpenCV's own float32
    arithmetic (each product and sum rounded, no FMA; a horizontal pass, then
    a vertical one), so equal bit for bit on the CPU and on the card. cv2
    builds with Intel IPP take IPP's resize for most float32 shapes, whose
    results stand within 3e-6 of OpenCV's own on values in [0, 1]
    (tests/test_torch_port_predict_io.py)."""
    x = x.float()
    h, w = x.shape[-2:]
    x0, x1, a0, a1 = _linear_taps(w, nw, True, x.device)
    y0, y1, b0, b1 = _linear_taps(h, nh, False, x.device)
    rows = x.index_select(-1, x0) * a0 + x.index_select(-1, x1) * a1
    return rows.index_select(-2, y0) * b0[:, None] + rows.index_select(-2, y1) * b1[:, None]


def scale_image(im1_shape, masks: torch.Tensor, im0_shape, ratio_pad=None) -> torch.Tensor:
    """Un-letterbox float masks (n, h, w) from the model input shape to the
    original image shape, on the masks' device (JAX ops/mask_ops.py:scale_image;
    reference utils/segment/general.py:70-95): the letterbox pad cropped, then
    cv2.resize INTER_LINEAR in OpenCV's own float32 arithmetic
    (`resize_linear_f32`)."""
    if ratio_pad is None:
        gain = min(im1_shape[0] / im0_shape[0], im1_shape[1] / im0_shape[1])
        pad = (im1_shape[1] - im0_shape[1] * gain) / 2, (im1_shape[0] - im0_shape[0] * gain) / 2
    else:
        pad = ratio_pad[1]
    top, left = int(pad[1]), int(pad[0])
    bottom, right = int(im1_shape[0] - pad[1]), int(im1_shape[1] - pad[0])
    if masks.ndim != 3:
        raise ValueError(f"masks must be (n, h, w), got shape {tuple(masks.shape)}")
    return resize_linear_f32(masks[:, top:bottom, left:right], int(im0_shape[0]),
                             int(im0_shape[1]))


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


def masks2segments(masks, strategy: str = "largest"):
    """Binary masks (n, h, w) -> one polygon each, (k, 2) float32 (x, y)
    points on the host (reference utils/segment/general.py:124-137): the
    outer contours of cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
    (ops/contours.py), concatenated ("concat") or the one with the most points,
    the first of equals ("largest"); (0, 2) for an empty mask."""
    if isinstance(masks, torch.Tensor):
        masks = masks.detach().cpu().numpy()
    segments = []
    for x in np.asarray(masks).astype(np.uint8):
        contours = find_external_contours(x)
        if contours:
            if strategy == "concat":
                c = np.concatenate(contours)
            else:
                c = contours[int(np.array([len(c) for c in contours]).argmax())]
        else:
            c = np.zeros((0, 2))
        segments.append(c.astype(np.float32))
    return segments
