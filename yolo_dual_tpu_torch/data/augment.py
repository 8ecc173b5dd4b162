"""Host-side geometry of the data pipeline (port of yolo_dual_tpu/data/augment.py;
reference utils/augmentations.py, utils/segment/augmentations.py and
utils/segment/dataloaders.py:274-331): label and polygon transforms, the
mosaic's perspective warp as a matrix (its pixels are warped on the device,
kernels/augment.py), the host letterbox, and polygon -> mask rasterisation.

The JAX package uses OpenCV for fillPoly, resize, getRotationMatrix2D,
warpAffine and GaussianBlur. The card's machine has no OpenCV, so they are
written here in numpy: `fill_poly` follows OpenCV's 8-connected edge drawing
and scanline fill of a polygon with integer vertices, `resize_linear_u8`
OpenCV's fixed-point INTER_LINEAR resize of a uint8 plane or frame,
`resize_area_u8` its INTER_AREA, `warp_affine_u8` OpenCV 5's float32
warpAffine (INTER_LINEAR, INTER_NEAREST, constant border) and
`gaussian_blur5_u8` its fixed-point 5x5 GaussianBlur at sigma 0. The
rasteriser is exact on axis-aligned rectangles with integer vertices, and on
other polygons a few edge pixels may differ; INTER_LINEAR, the warps and the
blur are exact; INTER_AREA may be off by one at non-integer ratios
(ROADMAP.md §C, held by tests/test_torch_port_data.py,
tests/test_torch_port_train_data.py and tests/test_torch_port_semantic_train.py).

The pixel augmentations of the host path (random_perspective's warp,
augment_hsv, mixup, copy_paste, cutout, Albumentations) are not ported: the
training dataset takes the device-augmentation path only (data/dataset.py).
"""

from __future__ import annotations

import math
import random

import numpy as np

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


# OpenCV 5's warpAffine computes each row in SIMD passes of this many pixels
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


def warp_affine_u8(img: np.ndarray, m: np.ndarray, dsize, linear: bool = True,
                   border: int = 0) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR or INTER_NEAREST,
    borderValue=border) of a uint8 plane (h, w) or frame (h, w, c), as
    OpenCV 5 computes it: the inverted matrix in float32, each destination
    pixel's source point x·m0 + (y·m1 + m2) by FMA (the scalar tail of a row:
    (x·m0 + y·m1) + m2), INTER_NEAREST rounding it half to even, INTER_LINEAR
    blending the four neighbours in float32 by FMAs and rounding half to
    even; neighbours outside the source take `border`."""
    w_out, h_out = dsize
    m = _invert_affine(m).astype(np.float32)
    ys = np.arange(h_out, dtype=np.float32)[:, None]
    xs = np.arange(w_out, dtype=np.float32)[None, :]
    tail = np.arange(w_out) >= w_out // WARP_LANES * WARP_LANES

    def source(r):
        body = _fma32(xs, m[r], ys * m[r + 1] + m[r + 2])
        scalar = _fma32(xs, m[r], ys * m[r + 1]) + m[r + 2]
        return np.where(tail, scalar, body)
    sx, sy = source(0), source(3)
    h, w = img.shape[:2]
    planes = img.reshape(h, w, -1)

    def pick(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = planes[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.asarray(border, img.dtype))
    if not linear:
        out = pick(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
        return out.reshape((h_out, w_out) + img.shape[2:])
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    p00, p01, p10, p11 = (pick(y0 + dy, x0 + dx).astype(np.float32)
                          for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
    top, bottom = _fma32(ax, p01 - p00, p00), _fma32(ax, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(ay, bottom - top, top)), 0, 255).astype(np.uint8)
    return out.reshape((h_out, w_out) + img.shape[2:])


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
