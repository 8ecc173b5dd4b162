"""Polygon -> mask rasterisation (port of the mask half of
yolo_dual_tpu/data/augment.py; reference utils/segment/dataloaders.py:274-331),
plus the label geometry helpers the val dataset uses.

The JAX package rasterises with cv2.fillPoly and downsamples with cv2.resize
(INTER_LINEAR). The card's machine has no OpenCV, so both are written here in
numpy: `fill_poly` follows OpenCV's 8-connected edge drawing and scanline
fill of a polygon with integer vertices, and `resize_linear_u8` OpenCV's
fixed-point bilinear resize of a uint8 plane. They are exact on axis-aligned
rectangles with integer vertices; on other polygons a few edge pixels may
differ (tests/test_torch_port_data.py holds the share).
"""

from __future__ import annotations

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


def _draw_line(mask: np.ndarray, p0, p1, color: int):
    """OpenCV's 8-connected line (LineIterator, left to right), clipped."""
    h, w = mask.shape
    clipped = _clip_line(w, h, p0, p1)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    i = np.arange(major + 1)
    # Bresenham: the minor coordinate steps where err = major - 2 minor (i + 1)
    # + 2 major (steps so far) goes negative
    steps = np.zeros(major + 1, np.int64)
    if major:
        steps[1:] = np.maximum(0, (2 * minor * np.arange(1, major + 1) - major
                                   + 2 * major - 1) // (2 * major))
    if dy > dx:
        xs, ys = x1 + steps, y1 + sy * i
    else:
        xs, ys = x1 + i, y1 + sy * steps
    mask[ys, xs] = color


def fill_poly(mask: np.ndarray, pts: np.ndarray, color: int = 1) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], color) for one polygon of integer vertices
    (n, 2) on a 2-D uint8 plane, in place: the edges drawn as 8-connected
    lines, then each scanline filled between pairs of edge crossings, an edge
    covering rows [y_top, y_bottom)."""
    h, w = mask.shape
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(pts)
    edges = []  # (y0, y1, x at y0 in fixed point, dx per row)
    for i in range(n):
        p0, p1 = pts[i - 1], pts[i]
        t0, t1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
        _draw_line(mask, t0, t1, color)
        if t0[1] == t1[1]:
            continue
        (x0c, y0c), (x1c, y1c) = t0, t1
        if not (0 <= min(t0[0], t1[0]) and max(t0[0], t1[0]) < w
                and 0 <= min(t0[1], t1[1]) and max(t0[1], t1[1]) < h):
            c = _clip_line(w, h, t0, t1)  # an edge leaving the plane runs along its clipped part
            if c is not None and c[0][1] != c[1][1]:
                (x0c, y0c), (x1c, y1c) = c
        x0c, x1c = x0c << XY_SHIFT, x1c << XY_SHIFT
        num, den = x1c - x0c, y1c - y0c
        dxf = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)  # C division
        if t0[1] < t1[1]:
            edges.append((t0[1], t1[1], x0c + (t0[1] - y0c) * dxf, dxf))
        else:
            edges.append((t1[1], t0[1], x1c + (t1[1] - y1c) * dxf, dxf))
    if len(edges) < 2:
        return mask
    e = np.array(edges, np.int64)
    rows = np.concatenate([np.arange(max(a, 0), min(b, h)) for a, b in e[:, :2]])
    if not len(rows):
        return mask
    first = np.concatenate([np.full(max(0, min(b, h) - max(a, 0)), i) for i, (a, b) in
                            enumerate(e[:, :2])])
    xs = e[first, 2] + (rows - e[first, 0]) * e[first, 3]                 # crossings, fixed point
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


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR source taps and fixed-point weights along one
    axis: the source coordinate in float32, each weight rounded on its own."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    x0 = np.floor(f).astype(np.int64)
    fx = f - x0.astype(np.float32)
    fx[(x0 < 0) | (x0 >= n_in - 1)] = 0
    x0 = np.clip(x0, 0, n_in - 1)
    one = np.float32(1 << COEF_BITS)
    w0 = np.rint((np.float32(1) - fx) * one).astype(np.int32)
    w1 = np.rint(fx * one).astype(np.int32)
    return x0, np.minimum(x0 + 1, n_in - 1), w0, w1


def resize_linear_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(img, (nw, nh)) of a 2-D uint8 plane with INTER_LINEAR:
    horizontal then vertical fixed-point passes, rounded as OpenCV rounds."""
    h, w = img.shape
    if (h, w) == (nh, nw):
        return img.copy()
    c0, c1, cw0, cw1 = _linear_taps(w, nw)
    r0, r1, rw0, rw1 = _linear_taps(h, nh)

    def horizontal(rows):                                        # (nh, nw), scaled by 2^11
        return rows[:, c0].astype(np.int32) * cw0 + rows[:, c1].astype(np.int32) * cw1
    s0, s1 = horizontal(img[r0]) >> 4, horizontal(img[r1]) >> 4
    out = (((rw0[:, None] * s0) >> 16) + ((rw1[:, None] * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


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
