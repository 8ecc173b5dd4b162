"""Device-side training augmentation: the mosaic composite, the perspective
warp, the HSV jitter, the flips and the /255 of a batch in one pass (port of
yolo_dual_tpu/kernels/augment.py:136 mosaic_warp_hsv, which is XLA, not
Pallas: plain batched torch on the card is its port).

The host ships each sample's four resized frames (tiles), their placement on
the virtual 2s x 2s mosaic canvas and the inverse of the sampled warp
(data/dataset.py:load_mosaic). For each output pixel the inverse warp gives a
canvas point; the placement rectangles are disjoint, so one tile (or none:
the fill 114) covers it, and that tile is sampled bilinearly with its edges
clamped. The canvas is never built, and the taps are gathered from the uint8
tiles at one tile index a pixel, so no (B, 4, s, s, 3) float temporary exists.
The semantics are JAX's: flips applied to the output coordinates before the
warp, the HSV jitter in float32 (no uint8 lookup tables), gains of exactly
(1, 1, 1) an exact no-op.
"""

from __future__ import annotations

import torch

FILL = 114.0


def _rgb_to_hsv(rgb: torch.Tensor):
    """(..., 3) float in [0, 255] -> h in [0, 1), s and v in [0, 255]."""
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    d = maxc - minc
    s = torch.where(maxc > 0, d / maxc.clamp_min(1e-12) * 255.0, 0.0)
    safe_d = d.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe_d, (maxc - g) / safe_d, (maxc - b) / safe_d
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h in [0, 1), s and v in [0, 255] -> (..., 3) float in [0, 255]."""
    sn = s / 255.0
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - sn)
    q = v * (1.0 - sn * f)
    t = v * (1.0 - sn * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sector = torch.stack([(i == k) for k in range(6)])                  # (6, ...)

    def pick(*vals):
        out = torch.zeros_like(v)
        for k, val in enumerate(vals):
            out = torch.where(sector[k], val, out)
        return out
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], -1)


def _hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """augment_hsv's semantics per sample (reference utils/augmentations.py:
    67-80): the hue scaled by gains[0] modulo cv2's 180, saturation and value
    scaled and clipped. img (B, H, W, 3) float, gains (B, 3)."""
    h, s, v = _rgb_to_hsv(img)
    g = gains[:, None, None, :]
    h2 = torch.remainder(h * 180.0 * g[..., 0], 180.0) / 180.0
    s2 = torch.clamp(s * g[..., 1], 0.0, 255.0)
    v2 = torch.clamp(v * g[..., 2], 0.0, 255.0)
    identity = (gains == 1.0).all(1)[:, None, None, None]
    return torch.where(identity, img, _hsv_to_rgb(h2, s2, v2))


def mosaic_warp_hsv(tiles: torch.Tensor, dst: torch.Tensor, off: torch.Tensor,
                    inv_m: torch.Tensor, hsv_gains: torch.Tensor, flips: torch.Tensor,
                    out_size: int = 640) -> torch.Tensor:
    """Batched device augmentation (JAX kernels/augment.py:136).

    tiles (B, 4, s, s, 3) uint8: each sample's mosaic frames zero-padded to
    (s, s); dst (B, 4, 4) float32: their rectangles x1, y1, x2, y2 on the
    canvas; off (B, 4, 2): the canvas -> tile coordinate offset of each;
    inv_m (B, 3, 3): the inverse warp; hsv_gains (B, 3); flips (B, 2) bool
    (up-down, left-right). Returns (B, out_size, out_size, 3) float32 in
    [0, 1] on the tiles' device."""
    B, _, s = tiles.shape[:3]
    dev = tiles.device
    o = out_size
    dst, off, inv_m, hsv_gains = (t.to(dev, torch.float32) for t in (dst, off, inv_m, hsv_gains))
    flips = flips.to(dev, torch.bool)
    ar = torch.arange(o, dtype=torch.float32, device=dev)
    yy = ar[None, :, None].expand(B, o, o)
    xx = ar[None, None, :].expand(B, o, o)
    yy = torch.where(flips[:, 0, None, None], (o - 1) - yy, yy)
    xx = torch.where(flips[:, 1, None, None], (o - 1) - xx, xx)
    m = inv_m[:, :, :, None, None]                                       # (B, 3, 3, 1, 1)
    w = m[:, 2, 0] * xx + m[:, 2, 1] * yy + m[:, 2, 2]
    w = torch.where(w.abs() < 1e-9, 1e-9, w)
    u = (m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]) / w
    v = (m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]) / w
    del xx, yy, w

    # the tile under each pixel: the last whose rectangle holds (u, v), as JAX's where-chain
    sel = torch.full((B, o, o), -1, dtype=torch.int64, device=dev)
    for k in range(4):
        x1, y1, x2, y2 = (dst[:, k, j, None, None] for j in range(4))
        sel = torch.where((u >= x1) & (u < x2) & (v >= y1) & (v < y2), k, sel)
    hit = sel >= 0
    sel.clamp_(min=0)
    offs = off.gather(1, sel.view(B, -1, 1).expand(-1, -1, 2)).view(B, o, o, 2)
    us, vs = u + offs[..., 0], v + offs[..., 1]
    del u, v, offs

    y0, x0 = torch.floor(vs), torch.floor(us)
    wy, wx = (vs - y0)[..., None], (us - x0)[..., None]
    y0i = y0.to(torch.int64).clamp(0, s - 1)
    x0i = x0.to(torch.int64).clamp(0, s - 1)
    y1i, x1i = (y0i + 1).clamp(max=s - 1), (x0i + 1).clamp(max=s - 1)
    base = (torch.arange(B, device=dev)[:, None, None] * 4 + sel) * (s * s)
    flat = tiles.reshape(-1, 3)

    def tap(yi, xi):
        return flat[base + yi * s + xi].to(torch.float32)               # (B, o, o, 3)
    out = tap(y0i, x0i) * (1 - wy) * (1 - wx)
    out += tap(y0i, x1i) * (1 - wy) * wx
    out += tap(y1i, x0i) * wy * (1 - wx)
    out += tap(y1i, x1i) * wy * wx
    out = torch.where(hit[..., None], out, FILL)
    return _hsv_jitter(out, hsv_gains) / 255.0
