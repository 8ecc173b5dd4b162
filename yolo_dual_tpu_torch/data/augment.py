"""Host-side augmentation of the data pipeline (port of
yolo_dual_tpu/data/augment.py; reference utils/augmentations.py,
utils/segment/augmentations.py and utils/segment/dataloaders.py:274-331):
label and polygon transforms, the perspective warp (as a matrix for the
device route, kernels/augment.py, and on the pixels for the host route), the
host letterbox, polygon -> mask rasterisation, and the host route's pixel
augmentations: augment_hsv, random_perspective, copy_paste, mixup, cutout and
the optional Albumentations adapter.

The JAX package uses OpenCV for fillPoly, drawContours, resize,
getRotationMatrix2D, warpAffine, warpPerspective, GaussianBlur, cvtColor,
LUT and flip. The card's machine has no OpenCV, so they are written here in
numpy: `fill_poly` follows OpenCV's 8-connected edge drawing and scanline
fill of a polygon with integer vertices (drawContours FILLED fills one the
same way), `resize_linear_u8` OpenCV's fixed-point INTER_LINEAR resize of a
uint8 plane or frame, `resize_area_u8` its INTER_AREA, `warp_affine_u8` and
`warp_perspective_u8` OpenCV 5's float32 warps (INTER_LINEAR, INTER_NEAREST,
constant border), `gaussian_blur5_u8` its fixed-point 5x5 GaussianBlur at
sigma 0, and `rgb_to_hsv_u8` / `hsv_to_rgb_u8` its 8-bit COLOR_RGB2HSV
(fixed-point division tables) and COLOR_HSV2RGB (float32, hue range 180).
The rasteriser is exact on axis-aligned rectangles with integer vertices,
and on other polygons a few edge pixels may differ; INTER_LINEAR, the warps,
the blur and both colour conversions are exact; INTER_AREA may be off by one
at non-integer ratios (ROADMAP.md §C, held by tests/test_torch_port_data.py,
tests/test_torch_port_train_data.py, tests/test_torch_port_semantic_train.py
and tests/test_torch_port_host_aug.py).
"""

from __future__ import annotations

import math
import random

import numpy as np

from yolo_dual_tpu_torch.utils.general import LOGGER

XY_SHIFT = 16  # OpenCV's fixed-point x of polygon edges
COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def xyn2xy(seg: np.ndarray, w: float, h: float, padw: float = 0, padh: float = 0):
    """Normalised polygon (n, 2) -> pixels, shifted by the pad."""
    out = seg.copy()
    out[:, 0] = seg[:, 0] * w + padw
    out[:, 1] = seg[:, 1] * h + padh
    return out


def xywhn2xyxy_np(x: np.ndarray, w: float = 640, h: float = 640,
                  padw: float = 0, padh: float = 0) -> np.ndarray:
    """Normalised centre-xywh -> pixel xyxy, shifted by the pad."""
    y = np.empty_like(x)
    y[..., 0] = x[..., 0] * w - x[..., 2] * w / 2 + padw
    y[..., 1] = x[..., 1] * h - x[..., 3] * h / 2 + padh
    y[..., 2] = x[..., 0] * w + x[..., 2] * w / 2 + padw
    y[..., 3] = x[..., 1] * h + x[..., 3] * h / 2 + padh
    if x.shape[-1] > 4:
        y[..., 4:] = x[..., 4:]
    return y


def xyxy2xywhn_np(x: np.ndarray, w: float = 640, h: float = 640,
                  clip: bool = False, eps: float = 0.0) -> np.ndarray:
    """Pixel xyxy -> normalised centre-xywh, optionally clipped to [0, w - eps]."""
    if clip:
        x = x.copy()
        x[..., 0] = x[..., 0].clip(0, w - eps)
        x[..., 1] = x[..., 1].clip(0, h - eps)
        x[..., 2] = x[..., 2].clip(0, w - eps)
        x[..., 3] = x[..., 3].clip(0, h - eps)
    y = np.empty_like(x)
    y[..., 0] = (x[..., 0] + x[..., 2]) / 2 / w
    y[..., 1] = (x[..., 1] + x[..., 3]) / 2 / h
    y[..., 2] = (x[..., 2] - x[..., 0]) / w
    y[..., 3] = (x[..., 3] - x[..., 1]) / h
    if x.shape[-1] > 4:
        y[..., 4:] = x[..., 4:]
    return y


def segment2box(segment: np.ndarray, width: float, height: float):
    """A polygon's xyxy box over its points inside [0, width] x [0, height]
    (zeros when none is; reference utils/general.py:801)."""
    x, y = segment[:, 0], segment[:, 1]
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    return np.array([x.min(), y.min(), x.max(), y.max()]) if any(x) else np.zeros(4)


def resample_segments(segments, n: int = 1000):
    """Each polygon closed and resampled to n points (reference
    utils/general.py:816-827)."""
    out = []
    for s in segments:
        s = np.concatenate((s, s[0:1, :]), axis=0)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.concatenate([np.interp(x, xp, s[:, i]) for i in range(2)]).reshape(2, -1).T)
    return out


def get_rotation_matrix_2d(angle: float, center, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: the 2x3 rotation by `angle` degrees
    (counter-clockwise) about `center`, scaled by `scale`, rounded as
    OpenCV computes it."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def sample_perspective_matrix(shape_hw, degrees=10, translate=0.1, scale=0.1, shear=10,
                              perspective=0.0, border=(0, 0), rng=None):
    """The reference's centre / perspective / rotation+scale / shear /
    translation warp T @ S @ R @ P @ C, drawn from `rng` in its order: two
    perspective, angle, scale, two shear, two translation draws (reference
    utils/segment/augmentations.py:28-52). Returns (M, scale, (width,
    height)); the labels are warped on the host, the pixels on the device
    (kernels/augment.py)."""
    rng = rng or random
    height = shape_hw[0] + border[0] * 2
    width = shape_hw[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -shape_hw[1] / 2
    C[1, 2] = -shape_hw[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = get_rotation_matrix_2d(a, (0, 0), s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    return T @ S @ R @ P @ C, s, (width, height)


def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep warped boxes wider and taller than wh_thr px, of aspect below
    ar_thr, that keep more than area_thr of their area (reference
    utils/augmentations.py:240)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def apply_perspective_to_labels(M, s, perspective, targets, segments, width, height):
    """Warp boxes and polygons (resampled to 1000 points) by M, box each
    polygon inside the canvas and drop degenerate candidates (reference
    utils/segment/augmentations.py:60-88)."""
    n = len(targets)
    new_segments = []
    if n:
        new = np.zeros((n, 4))
        segments = resample_segments(segments)
        for i, segment in enumerate(segments):
            xy = np.ones((len(segment), 3))
            xy[:, :2] = segment
            xy = xy @ M.T
            xy = xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
            new[i] = segment2box(xy, width, height)
            new_segments.append(xy)
        i = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T, area_thr=0.01)
        targets = targets[i]
        targets[:, 1:5] = new[i]
        new_segments = [new_segments[j] for j, keep in enumerate(i) if keep]
    return targets, new_segments


def _clip_line(w: int, h: int, p0, p1):
    """Cohen-Sutherland clip of the segment p0-p1 to [0, w-1] x [0, h-1], in
    integers as OpenCV's clipLine does; None when it misses the image."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if c1 & c2 == 0 and c1 | c2:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if c1 & c2 == 0 and c1 | c2:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _draw_lines(mask: np.ndarray, p0: np.ndarray, p1: np.ndarray, color: int):
    """OpenCV's 8-connected lines (LineIterator, left to right) for many edges
    at once: p0, p1 (n, 2) integer endpoints, every one inside the plane
    (fill_poly clips the others first)."""
    swap = p1[:, 0] < p0[:, 0]
    a = np.where(swap[:, None], p1, p0)
    b = np.where(swap[:, None], p0, p1)
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    steep = dy > dx
    major, minor = np.where(steep, dy, dx), np.where(steep, dx, dy)
    n = major + 1
    e = np.repeat(np.arange(len(n)), n)                         # edge of each point
    i = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)     # its step along the edge
    # Bresenham: the minor coordinate steps where err = major - 2 minor (i + 1)
    # + 2 major (steps so far) goes negative
    M, m = major[e], minor[e]
    steps = np.maximum(0, (2 * m * i + M - 1) // np.maximum(2 * M, 1))
    st = steep[e]
    mask[np.where(st, a[e, 1] + sy[e] * i, a[e, 1] + sy[e] * steps),
         np.where(st, a[e, 0] + steps, a[e, 0] + i)] = color


def fill_poly(mask: np.ndarray, pts: np.ndarray, color: int = 1) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], color) for one polygon of integer vertices
    (n, 2) on a 2-D uint8 plane, in place: the edges drawn as 8-connected
    lines, then each scanline filled between pairs of edge crossings, an edge
    covering rows [y_top, y_bottom)."""
    h, w = mask.shape
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    p0, p1 = np.roll(pts, 1, axis=0), pts                       # edge i runs pts[i-1] -> pts[i]
    inside = ((np.minimum(p0, p1) >= 0).all(1) & (np.maximum(p0[:, 0], p1[:, 0]) < w)
              & (np.maximum(p0[:, 1], p1[:, 1]) < h))
    c0, c1 = p0.copy(), p1.copy()  # each edge clipped to the plane
    drawn = inside.copy()
    for i in np.flatnonzero(~inside):
        c = _clip_line(w, h, (int(p0[i, 0]), int(p0[i, 1])), (int(p1[i, 0]), int(p1[i, 1])))
        if c is not None:
            c0[i], c1[i] = c
            drawn[i] = True
    _draw_lines(mask, c0[drawn], c1[drawn], color)
    # an edge leaving the plane runs the scanlines along its clipped part, unless
    # that part is missing or flat
    whole = ~drawn | (c0[:, 1] == c1[:, 1])
    c0[whole], c1[whole] = p0[whole], p1[whole]
    keep = p0[:, 1] != p1[:, 1]
    p0, p1, c0, c1 = p0[keep], p1[keep], c0[keep], c1[keep]
    num = (c1[:, 0] - c0[:, 0]) << XY_SHIFT
    den = c1[:, 1] - c0[:, 1]
    dxf = np.abs(num) // np.abs(den) * np.where((num >= 0) == (den > 0), 1, -1)  # C division
    down = p0[:, 1] < p1[:, 1]
    top = np.where(down, p0[:, 1], p1[:, 1])
    x_top = np.where(down, (c0[:, 0] << XY_SHIFT) + (p0[:, 1] - c0[:, 1]) * dxf,
                     (c1[:, 0] << XY_SHIFT) + (p1[:, 1] - c1[:, 1]) * dxf)
    if len(top) < 2:
        return mask
    lo, hi = np.maximum(top, 0), np.minimum(np.where(down, p1[:, 1], p0[:, 1]), h)
    cnt = np.maximum(hi - lo, 0)                                # rows an edge crosses
    first = np.repeat(np.arange(len(cnt)), cnt)
    rows = lo[first] + np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    if not len(rows):
        return mask
    xs = x_top[first] + (rows - top[first]) * dxf[first]                 # crossings, fixed point
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # crossings pair up row by row (each row has an even count), left then right;
    # a span runs from the left crossing rounded up to the right one rounded down
    xl = (xs[0::2] + (1 << XY_SHIFT) - 1) >> XY_SHIFT
    xr = xs[1::2] >> XY_SHIFT
    y = rows[0::2]
    keep = (xl < w) & (xr >= 0)
    y, xl, xr = y[keep], np.maximum(xl[keep], 0), np.minimum(xr[keep], w - 1)
    y0 = rows[0]
    span = np.zeros((rows[-1] + 1 - y0, w + 1), np.int16)               # +1 at a span's start,
    np.add.at(span, (y - y0, xl), 1)                                       # -1 past its end
    np.add.at(span, (y - y0, xr + 1), -1)
    mask[y0:rows[-1] + 1][span.cumsum(1, dtype=np.int16)[:, :w] > 0] = color
    return mask


def _linear_taps(n_in: int, n_out: int, clamp: bool = True):
    """OpenCV's INTER_LINEAR source taps and fixed-point weights along one
    axis: the source coordinate in float32, each weight rounded on its own.
    Past the edges OpenCV clamps the columns' coordinate (clamp=True: one tap
    of weight 1) but only the rows' indices, keeping both rounded weights."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    x0 = np.floor(f).astype(np.int64)
    fx = f - x0.astype(np.float32)
    if clamp:
        fx[(x0 < 0) | (x0 >= n_in - 1)] = 0
        x0 = np.clip(x0, 0, n_in - 1)
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    x0 = np.clip(x0, 0, n_in - 1)
    one = np.float32(1 << COEF_BITS)
    w0 = np.rint((np.float32(1) - fx) * one).astype(np.int32)
    w1 = np.rint(fx * one).astype(np.int32)
    return x0, x1, w0, w1


def resize_linear_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(img, (nw, nh)) of a uint8 plane (h, w) or frame (h, w, c)
    with INTER_LINEAR, up or down: horizontal then vertical fixed-point passes,
    rounded as OpenCV rounds."""
    h, w = img.shape[:2]
    if (h, w) == (nh, nw):
        return img.copy()
    c0, c1, cw0, cw1 = _linear_taps(w, nw)
    r0, r1, rw0, rw1 = _linear_taps(h, nh, clamp=False)
    if img.ndim == 3:
        cw0, cw1 = cw0[:, None], cw1[:, None]
    vshape = (nh,) + (1,) * (img.ndim - 1)

    def horizontal(rows):                                        # (nh, nw[, c]), scaled by 2^11
        return rows[:, c0].astype(np.int32) * cw0 + rows[:, c1].astype(np.int32) * cw1
    s0, s1 = horizontal(img[r0]) >> 4, horizontal(img[r1]) >> 4
    out = (((rw0.reshape(vshape) * s0) >> 16) + ((rw1.reshape(vshape) * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of OpenCV's INTER_AREA along one axis
    (computeResizeAreaTab): each output cell averages the source cells it
    covers, partial cells by the covered fraction."""
    scale = n_in / n_out
    wt = np.zeros((n_out, n_in))
    for dx in range(n_out):
        fsx1, fsx2 = dx * scale, dx * scale + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            wt[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        wt[dx, sx1:sx2] = np.float32(1 / cell)
        if fsx2 - sx2 > 1e-3:
            wt[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return wt


def resize_area_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA) of a uint8
    plane or frame, for shrinking (OpenCV takes INTER_LINEAR to enlarge).
    Integer ratios average whole blocks (resizeAreaFast: a 2x2 block rounded
    half up, larger blocks to even); others are the weighted sums of
    `_area_weights`, in float64 here and float32 in OpenCV, so an output that
    falls within float32 rounding of a half may round the other way
    (ROADMAP.md §C)."""
    h, w = img.shape[:2]
    if (h, w) == (nh, nw):
        return img.copy()
    if nh > h or nw > w:
        return resize_linear_u8(img, nh, nw)
    sy, sx = h / nh, w / nw
    if sy == int(sy) and sx == int(sx):
        ky, kx = int(sy), int(sx)
        blocks = img[:nh * ky, :nw * kx].reshape(nh, ky, nw, kx, *img.shape[2:]).astype(np.int64)
        total = blocks.sum((1, 3))
        if ky == kx == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        return np.rint(total.astype(np.float32) * np.float32(1 / (ky * kx))).astype(np.uint8)
    out = np.einsum("yh,hw...->yw...", _area_weights(h, nh), img.astype(np.float64))
    out = np.einsum("xw,yw...->yx...", _area_weights(w, nw), out)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def letterbox(im: np.ndarray, new_shape=640, scaleup: bool = True, color: int = 114):
    """Aspect-preserving resize (INTER_LINEAR) and centred constant pad to
    new_shape (an int or (h, w)), as JAX's letterbox with auto=False
    (reference utils/augmentations.py:111-141; cv2.resize + copyMakeBorder
    there). Returns (image, (rw, rh), (dw, dh))."""
    shape = im.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = (new_shape[1] - new_unpad[0]) / 2, (new_shape[0] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        im = resize_linear_u8(im, new_unpad[1], new_unpad[0])
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = np.full((new_shape[0], new_shape[1], *im.shape[2:]), color, im.dtype)
    out[top:top + im.shape[0], left:left + im.shape[1]] = im
    return out, (r, r), (dw, dh)


def polygon2mask(img_size, polygons, color: int = 1, downsample_ratio: int = 1) -> np.ndarray:
    """Rasterise one polygon onto an img_size (h, w) plane, then downsample by
    `downsample_ratio` (reference utils/segment/dataloaders.py:274-289)."""
    mask = np.zeros(img_size, dtype=np.uint8)
    polygons = np.asarray(polygons).astype(np.int32).reshape(-1, 2)
    fill_poly(mask, polygons, color)
    nh, nw = img_size[0] // downsample_ratio, img_size[1] // downsample_ratio
    return resize_linear_u8(mask, nh, nw)


def polygons2masks(img_size, polygons, color, downsample_ratio=1):
    """One plane per polygon: (n, h / ratio, w / ratio) uint8."""
    return np.array([polygon2mask(img_size, [p.reshape(-1)], color, downsample_ratio)
                     for p in polygons])


def polygons2masks_overlap(img_size, segments, downsample_ratio=1):
    """All instances in ONE index-encoded plane, sorted by area descending so
    small objects overwrite big ones; returns (mask, sorted_index)
    (reference utils/segment/dataloaders.py:309-331)."""
    mask = np.zeros((img_size[0] // downsample_ratio, img_size[1] // downsample_ratio),
                    dtype=np.int32 if len(segments) > 255 else np.uint8)
    areas = []
    ms = []
    for si in range(len(segments)):
        m = polygon2mask(img_size, [segments[si].reshape(-1)], 1, downsample_ratio)
        ms.append(m)
        areas.append(m.sum())
    areas = np.asarray(areas)
    index = np.argsort(-areas)
    ms = np.array(ms)[index]
    for i in range(len(segments)):
        m = ms[i] * (i + 1)
        mask = mask + m
        mask = np.clip(mask, a_min=0, a_max=i + 1)
    return mask, index


# OpenCV 5's warpAffine and warpPerspective compute each row in SIMD passes of this many pixels
# (AVX-512 float32 lanes) and the row's remaining pixels in scalar code, whose
# source coordinate the compiler contracts into another FMA.
WARP_LANES = 16


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine matrix as cv2.warpAffine computes it, in
    float64 (flattened to 6 values)."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as an FMA instruction rounds it (the
    product of two float32 values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.float64(b) + np.asarray(c, np.float64)).astype(np.float32)


def _remap_u8(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, linear: bool,
              border: int) -> np.ndarray:
    """Sample a uint8 plane or frame at the float32 source points (sx, sy) of
    each destination pixel, as OpenCV 5's warps do: INTER_NEAREST rounds the
    point half to even, INTER_LINEAR blends the four neighbours in float32 by
    FMAs and rounds half to even; neighbours outside the source take
    `border`."""
    h, w = img.shape[:2]
    planes = img.reshape(h, w, -1)

    def pick(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = planes[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.asarray(border, img.dtype))
    if not linear:
        out = pick(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
        return out.reshape(sx.shape + img.shape[2:])
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    p00, p01, p10, p11 = (pick(y0 + dy, x0 + dx).astype(np.float32)
                          for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
    top, bottom = _fma32(ax, p01 - p00, p00), _fma32(ax, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(ay, bottom - top, top)), 0, 255).astype(np.uint8)
    return out.reshape(sx.shape + img.shape[2:])


def _row_terms(m: np.ndarray, h_out: int, w_out: int):
    """The float32 terms x·m[r] + (y·m[r+1] + m[r+2]) of each destination
    pixel as OpenCV 5 computes them: by FMA in the SIMD passes of a row, and
    (x·m[r] + y·m[r+1]) + m[r+2] in its scalar tail past a multiple of
    WARP_LANES pixels. Returns a function of the row r of m."""
    ys = np.arange(h_out, dtype=np.float32)[:, None]
    xs = np.arange(w_out, dtype=np.float32)[None, :]
    tail = np.arange(w_out) >= w_out // WARP_LANES * WARP_LANES

    def term(r):
        body = _fma32(xs, m[r], ys * m[r + 1] + m[r + 2])
        scalar = _fma32(xs, m[r], ys * m[r + 1]) + m[r + 2]
        return np.where(tail, scalar, body)
    return term


def warp_affine_u8(img: np.ndarray, m: np.ndarray, dsize, linear: bool = True,
                   border: int = 0) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR or INTER_NEAREST,
    borderValue=border) of a uint8 plane (h, w) or frame (h, w, c), as
    OpenCV 5 computes it: the inverted matrix in float32, each destination
    pixel's source point x·m0 + (y·m1 + m2) by FMA (the scalar tail of a row:
    (x·m0 + y·m1) + m2), then `_remap_u8`."""
    w_out, h_out = dsize
    term = _row_terms(_invert_affine(m).astype(np.float32), h_out, w_out)
    return _remap_u8(img, term(0), term(3), linear, border)


def _invert_3x3(m: np.ndarray) -> np.ndarray:
    """The inverse of a 3x3 matrix as cv::invert computes it for warpPerspective:
    cofactors over the determinant in float64 (flattened to 9 values)."""
    S = np.asarray(m, np.float64)
    d = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
         - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
         + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    d = 1.0 / d if d != 0 else 0.0
    return np.array([
        (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d, (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
        (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d, (S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d,
        (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d, (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d,
        (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d, (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
        (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d])


def warp_perspective_u8(img: np.ndarray, m: np.ndarray, dsize, border: int = 0) -> np.ndarray:
    """cv2.warpPerspective(img, m, dsize, borderValue=border) (INTER_LINEAR)
    of a uint8 plane or frame, as OpenCV 5 computes it: the inverted matrix in
    float32, each destination pixel's numerator and denominator terms as
    warp_affine_u8 computes its source point, their float32 quotients the
    source point, then `_remap_u8`."""
    w_out, h_out = dsize
    term = _row_terms(_invert_3x3(m).astype(np.float32), h_out, w_out)
    den = term(6)
    return _remap_u8(img, term(0) / den, term(3) / den, True, border)


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of -pad .. n + pad - 1 under BORDER_REFLECT_101."""
    i = np.abs(np.arange(-pad, n + pad))
    return np.where(i > n - 1, 2 * (n - 1) - i, i) if n > 1 else np.zeros_like(i)


def gaussian_blur5_u8(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (5, 5), 0) of a uint8 plane or frame: OpenCV's
    kernel [1, 4, 6, 4, 1] / 16 for ksize 5 at sigma 0, separable, with
    BORDER_REFLECT_101; its fixed-point passes are exact, so the result is
    the 5x5 sum S of weight·value (weights summing to 256) rounded half up,
    (S + 128) >> 8."""
    k = (1, 4, 6, 4, 1)
    h, w = img.shape[:2]
    x = img.astype(np.int32)[_reflect101(h, 2)][:, _reflect101(w, 2)]
    rows = sum(k[j] * x[:, j:j + w] for j in range(5))
    return ((sum(k[j] * rows[j:j + h] for j in range(5)) + 128) >> 8).astype(np.uint8)


# OpenCV's 8-bit COLOR_RGB2HSV divides through fixed-point tables with this
# shift; its COLOR_HSV2RGB converts each row in SIMD blocks of this many pixels
# (4 vectors of 8 float32 lanes), truncating to uint8, and the row's remaining
# pixels in scalar code, rounding half to even.
HSV_SHIFT = 12
HSV_LANES = 32
HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _hsv_division_tables():
    """OpenCV's sdiv_table and hdiv_table180: round((255 << 12) / i) and
    round((180 << 12) / (6 i)), half to even, 0 at i = 0."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv, hdiv = np.zeros(256, np.int64), np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_division_tables()


def rgb_to_hsv_u8(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, cv2.COLOR_RGB2HSV) of a uint8 RGB frame: V the
    largest channel, S and H by OpenCV's fixed-point division tables, hue in
    [0, 180)."""
    x = im.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) of a uint8 (h, w, 3) frame, hue
    range 180, as OpenCV computes it in float32: S and V scaled by 1/255, the
    hue's sector and fraction f, the four values V, V(1 - S), V·fma(-S, f, 1)
    and V·fma(-S, 1 - f, 1) picked by sector, times 255; truncated in a row's
    SIMD blocks of HSV_LANES pixels, rounded half to even in its tail."""
    one = np.float32(1)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180)
    s = hsv[..., 1].astype(np.float32) * np.float32(1 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1 / 255.0)
    pre = np.trunc(h)
    f = h - pre
    tabs = np.stack([v, v * (one - s), v * _fma32(-s, f, one), v * _fma32(-s, one - f, one)], -1)
    bgr = np.take_along_axis(tabs, HSV_SECTORS[pre.astype(np.int64) % 6], -1) * np.float32(255)
    w = hsv.shape[1]
    simd = (np.arange(w) < w // HSV_LANES * HSV_LANES)[:, None]
    out = np.where(simd, np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def augment_hsv(im: np.ndarray, hgain=0.5, sgain=0.5, vgain=0.5, rng=None) -> np.ndarray:
    """Random HSV jitter (JAX data/augment.py:49-61; reference
    utils/augmentations.py:67-87): three gains drawn from `rng`, each channel
    of the frame's HSV mapped through its lookup table, back to RGB."""
    rng = rng or random
    if hgain or sgain or vgain:
        r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
        hsv = rgb_to_hsv_u8(im)
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(im.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
        im = hsv_to_rgb_u8(np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]],
                                     lut_val[hsv[..., 2]]], -1))
    return im


def random_perspective(im, targets=(), segments=(), degrees=10, translate=0.1, scale=0.1,
                       shear=10, perspective=0.0, border=(0, 0), rng=None):
    """Random affine or perspective warp of a frame, its labels and polygons
    (JAX data/augment.py:179-193; reference utils/segment/augmentations.py:16-88):
    the matrix of sample_perspective_matrix, the pixels by warp_affine_u8 (or
    warp_perspective_u8 when perspective is not 0) at border 114."""
    M, s, (width, height) = sample_perspective_matrix(
        im.shape[:2], degrees, translate, scale, shear, perspective, border, rng)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = warp_perspective_u8(im, M, (width, height), border=114)
        else:
            im = warp_affine_u8(im, M[:2], (width, height), border=114)
    targets, new_segments = apply_perspective_to_labels(
        M, s, perspective, targets, segments, width, height)
    return im, targets, new_segments


def _bbox_ioa_np(box: np.ndarray, boxes: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over the area of each of `boxes` (n, 4) with `box` (4,),
    all xyxy (reference utils/metrics.py bbox_ioa)."""
    ix = (np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0])).clip(0)
    iy = (np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1])).clip(0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) + eps
    return ix * iy / area


def copy_paste(im, labels, segments, p=0.5, rng=None):
    """Copy-paste (JAX data/augment.py:204-226; reference
    utils/augmentations.py:240-270): round(p · n) instances drawn from `rng`,
    each mirrored left-right and pasted where its mirror overlaps no label's
    box by 30% or more; the mirrored label and polygon are appended."""
    rng = rng or random
    n = len(segments)
    if p and n:
        h, w, _ = im.shape
        im_new = np.zeros((h, w), np.uint8)
        for j in rng.sample(range(n), k=round(p * n)):
            l, seg = labels[j], segments[j]
            box = w - l[3], l[2], w - l[1], l[4]
            ioa = _bbox_ioa_np(np.asarray(box, np.float32), labels[:, 1:5].astype(np.float32))
            if (ioa < 0.30).all():
                labels = np.concatenate((labels, [[l[0], *box]]), 0)
                segments.append(np.concatenate((w - seg[:, 0:1], seg[:, 1:2]), 1))
                # cv2.drawContours(..., FILLED) of the int32 polygon
                fill_poly(im_new, seg.astype(np.int32), 1)
        i = im_new[:, ::-1].astype(bool)
        im[i] = im[:, ::-1][i]
    return im, labels, segments


def mixup(im, labels, segments, im2, labels2, segments2, rng=None):
    """Blend two frames by r ~ Beta(32, 32) and join their labels (JAX
    data/augment.py:229-235; reference utils/segment/augmentations.py:91-104).
    r comes from the numpy RandomState `rng` (numpy's global one by default,
    which JAX's draws from)."""
    r = (np.random if rng is None else rng).beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    labels = np.concatenate((labels, labels2), 0)
    segments = list(segments) + list(segments2)
    return im, labels, segments


def cutout(im: np.ndarray, labels: np.ndarray, p: float = 0.5, rng=None):
    """Random-erase patches of a frame with normalised xywh labels; labels
    more than 60% covered by a patch of at least 1/32 of the frame are
    dropped (JAX data/augment.py:247-268; reference utils/augmentations.py:262-286)."""
    rng = rng or random
    if rng.random() < p:
        h, w = im.shape[:2]
        scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
        for s in scales:
            mask_h = rng.randint(1, max(1, int(h * s)))
            mask_w = rng.randint(1, max(1, int(w * s)))
            xmin = max(0, rng.randint(0, w) - mask_w // 2)
            ymin = max(0, rng.randint(0, h) - mask_h // 2)
            xmax = min(w, xmin + mask_w)
            ymax = min(h, ymin + mask_h)
            im[ymin:ymax, xmin:xmax] = [rng.randint(64, 191) for _ in range(3)]
            if len(labels) and s > 0.03:
                box = np.array([xmin, ymin, xmax, ymax], np.float32)
                xyxy = xywhn2xyxy_np(labels[:, 1:5].astype(np.float32), w, h)
                labels = labels[_bbox_ioa_np(box, xyxy) < 0.60]
    return im, labels


class Albumentations:
    """The optional albumentations adapter (JAX data/augment.py:271-314;
    reference utils/augmentations.py:22-53): Blur, MedianBlur, ToGray and
    CLAHE at p 0.01 with YOLO box passthrough. A no-op, drawing nothing from
    the generator, when the package does not import."""

    def __init__(self, size: int = 640):
        self.transform = None
        try:
            import albumentations as A
            T = [A.Blur(p=0.01), A.MedianBlur(p=0.01), A.ToGray(p=0.01), A.CLAHE(p=0.01),
                 A.RandomBrightnessContrast(p=0.0), A.RandomGamma(p=0.0),
                 A.ImageCompression(quality_lower=75, p=0.0)]
            self.transform = A.Compose(
                T, bbox_params=A.BboxParams(format="yolo", label_fields=["class_labels"]))
            LOGGER.info("albumentations: " + ", ".join(type(t).__name__ for t in T if t.p))
        except ImportError:
            pass
        except Exception as e:  # a version of the package that refuses these arguments
            LOGGER.warning(f"albumentations: disabled ({e})")
            self.transform = None

    def __call__(self, im, labels, p: float = 1.0, rng=None):
        rng = rng or random
        if self.transform and rng.random() < p:
            new = self.transform(image=im, bboxes=labels[:, 1:5], class_labels=labels[:, 0])
            im = new["image"]
            if len(new["bboxes"]):
                labels = np.array([[c, *b] for c, b in zip(new["class_labels"], new["bboxes"])],
                                  np.float32)
            else:
                labels = np.zeros((0, 5), np.float32)
        return im, labels
