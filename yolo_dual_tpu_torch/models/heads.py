"""Detection / instance-segmentation heads with anchor decode (port of
yolo_dual_tpu/models/heads.py; reference models/yolo.py:38-106).

Raw level maps keep the JAX package's logical layout (bs, na, ny, nx, no): a
view of the 1x1 conv output (bs, na·no, ny, nx), so producing it copies nothing.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from yolo_dual_tpu_torch.nn.common import Proto


def _level_grid(ny: int, nx: int, device, dtype=torch.float32):
    """(1, 1, ny, nx, 2) grid of cell (x, y) offsets minus 0.5 (ref models/yolo.py:81-89)."""
    yv, xv = torch.meshgrid(torch.arange(ny, device=device, dtype=dtype),
                            torch.arange(nx, device=device, dtype=dtype), indexing="ij")
    return (torch.stack((xv, yv), -1) - 0.5)[None, None]


class Detect(nn.Module):
    """Anchor-based YOLO detection head (reference models/yolo.py:38-89).

    anchors: ((w,h)*na per level) in input pixels; strides: per-level stride.
    """

    def __init__(self, nc: int, anchors: Tuple[Tuple[float, ...], ...],
                 strides: Tuple[int, ...], nm: int = 0, ch: Sequence[int] = ()):
        super().__init__()
        self.nc, self.nm = nc, nm
        self.anchors = tuple(tuple(a) for a in anchors)
        self.strides = tuple(strides)
        self.na = len(anchors[0]) // 2
        self.nl = len(anchors)
        self.no = nc + 5 + nm
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1) for c in ch)

    def forward(self, xs, decode: bool = True):
        na, no = self.na, self.no
        raw = []
        for i, x in enumerate(xs):
            p = self.m[i](x)
            bs, _, ny, nx = p.shape
            # (bs, na·no, ny, nx) -> (bs, na, ny, nx, no), a view
            raw.append(p.view(bs, na, no, ny, nx).permute(0, 1, 3, 4, 2))
        return self.decoded(raw) if decode else raw

    def decoded(self, raw):
        """forward(decode=True)'s output from forward(decode=False)'s `raw`:
        (the decoded predictions (bs, N, no), raw)."""
        na, no = self.na, self.no
        z = []
        for i, p in enumerate(raw):
            bs, _, ny, nx, _ = p.shape
            stride = float(self.strides[i])
            grid = _level_grid(ny, nx, p.device, p.dtype)
            anchor_grid = torch.tensor(self.anchors[i], dtype=p.dtype,
                                       device=p.device).view(1, na, 1, 1, 2)
            if self.nm:
                xy, wh, conf, mask = p.split((2, 2, 1 + self.nc, self.nm), -1)
                xy = (xy.sigmoid() * 2 + grid) * stride
                wh = (wh.sigmoid() * 2) ** 2 * anchor_grid
                y = torch.cat((xy, wh, conf.sigmoid(), mask), -1)
            else:
                ps = p.sigmoid()
                xy = (ps[..., :2] * 2 + grid) * stride
                wh = (ps[..., 2:4] * 2) ** 2 * anchor_grid
                y = torch.cat((xy, wh, ps[..., 4:]), -1)
            z.append(y.reshape(bs, na * ny * nx, no))
        return torch.cat(z, 1), raw


class Segment(Detect):
    """Detect + mask coefficients + Proto net (reference models/yolo.py:92-106).
    The torch reference subclasses Detect, so its convs are `m.{i}` and the
    proto net is `proto` (no `detect` level, unlike the JAX variable tree)."""

    def __init__(self, nc: int, anchors, strides, nm: int = 32, npr: int = 256,
                 ch: Sequence[int] = ()):
        super().__init__(nc, anchors, strides, nm=nm, ch=ch)
        self.npr = npr
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, xs, decode: bool = True):
        protos = self.proto(xs[0])
        det = super().forward(xs, decode=False)
        return self.decoded((det, protos)) if decode else (det, protos)

    def decoded(self, out):
        """(pred, protos, raw) from forward(decode=False)'s (raw, protos)."""
        raw, protos = out
        pred, raw = super().decoded(raw)
        return pred, protos, raw


class DetectAux(nn.Module):
    """The AuxOTA dual head (JAX models/heads.py:119; reference
    models/yolo_AuxOTA.py): 2·nl inputs, the first nl through a Detect `lead`,
    the rest each through a 1x1 conv `m_aux_{i}` to the lead's raw layout.
    decode=False returns the 2·nl raw maps, lead first; decode=True returns
    (the lead's decoded predictions, the 2·nl raw maps)."""

    def __init__(self, nc: int, anchors: Tuple[Tuple[float, ...], ...],
                 strides: Tuple[int, ...], ch: Sequence[int] = ()):
        super().__init__()
        nl = len(anchors)
        if len(ch) != 2 * nl:
            raise ValueError(f"DetectAux expects {2 * nl} inputs, got {len(ch)}")
        self.lead = Detect(nc, anchors, strides, ch=ch[:nl])
        self.nc, self.nl, self.na, self.no = nc, nl, self.lead.na, nc + 5
        for i, c in enumerate(ch[nl:]):
            setattr(self, f"m_aux_{i}", nn.Conv2d(c, self.no * self.na, 1))

    @property
    def anchors(self):
        return self.lead.anchors

    @property
    def strides(self):
        return self.lead.strides

    def forward(self, xs, decode: bool = True):
        out = self.lead(xs[:self.nl], decode=False)
        aux = []
        for i, x in enumerate(xs[self.nl:]):
            p = getattr(self, f"m_aux_{i}")(x)
            bs, _, ny, nx = p.shape
            aux.append(p.view(bs, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2))
        return self.decoded(out + aux) if decode else out + aux

    def decoded(self, raw):
        """(the lead's decoded predictions, raw) from forward(decode=False)'s raw."""
        return self.lead.decoded(raw[:self.nl])[0], raw
