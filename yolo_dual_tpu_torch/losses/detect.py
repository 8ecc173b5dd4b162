"""Anchor-assignment detection loss (port of yolo_dual_tpu/losses/detect.py;
reference utils/loss.py:91-234).

Targets arrive padded per image: (bs, M, 5) [cls, x, y, w, h] normalised, with
a validity mask (bs, M), as the JAX package's loader yields them. The
assignment is the JAX package's dense candidate lattice (5 offsets × na × bs·M)
with a boolean mask in place of the reference's compaction; every reduction is
a masked sum, which gives the reference's filtered-tensor math.

The objectness target of a cell hit by several candidates is the largest of
their IoUs (scatter-max), as in JAX; the reference's overwrite leaves the
winner undefined unless sort_obj_iou (ROADMAP §C, docs/PARITY.md #1).

Inside parallel/mesh.py:across(mesh) each rank's call returns its share of
the global batch's loss and items: the positives, the objectness cells and
the batch size are counted over every rank (global_sum, mean_share), as JAX's
jit over the sharded global batch counts them; the shares sum to that loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolo_dual_tpu_torch.ops.boxes import bbox_iou
from yolo_dual_tpu_torch.parallel.mesh import global_sum, mean_share


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """Positive/negative BCE targets for label smoothing (reference utils/loss.py:13)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(x, t, pos_weight: float = 1.0):
    """Elementwise BCEWithLogitsLoss with pos_weight."""
    return pos_weight * t * F.softplus(-x) + (1.0 - t) * F.softplus(x)


def focal_bce_with_logits(x, t, pos_weight: float = 1.0, gamma: float = 1.5, alpha: float = 0.25):
    """FocalLoss around BCE (reference utils/loss.py:35-56)."""
    p = torch.sigmoid(x)
    p_t = t * p + (1 - t) * (1 - p)
    alpha_f = t * alpha + (1 - t) * (1 - alpha)
    return bce_with_logits(x, t, pos_weight) * alpha_f * (1.0 - p_t) ** gamma


_OFFSETS = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], np.float32) * 0.5


@dataclasses.dataclass
class Assignment:
    """Dense per-level target assignment: every field is (K,) or (K, ...) with
    K = 5 · na · bs · M, plus the validity mask."""
    b: torch.Tensor       # image index
    a: torch.Tensor       # anchor index
    gj: torch.Tensor      # grid row
    gi: torch.Tensor      # grid column
    tbox: torch.Tensor    # (K, 4) xywh in grid units, xy relative to the cell
    cls: torch.Tensor     # class id
    tidx: torch.Tensor    # per-image target index (mask GT lookup)
    xywhn: torch.Tensor   # (K, 4) normalised xywh (mask crop and area)
    anch: torch.Tensor    # (K, 2) anchor wh in grid units
    valid: torch.Tensor   # bool


def build_targets_level(targets: torch.Tensor, tmask: torch.Tensor, anchors_l: torch.Tensor,
                        ny: int, nx: int, anchor_t: float, bias: float = 0.5) -> Assignment:
    """Assignment for one level (JAX losses/detect.py:69-137; reference
    utils/segment/loss.py:118-186 without compaction). targets (bs, M, 5),
    tmask (bs, M) bool, anchors_l (na, 2) in grid units. `bias` is the
    neighbour-cell reach: 0.5, the reference's g, or 1.0 for AuxOTA's aux
    branch (its find_5_positive), whose offsets are whole cells."""
    bs, M, _ = targets.shape
    na = anchors_l.shape[0]
    nt = bs * M
    dev = targets.device
    gain = torch.tensor([nx, ny], dtype=torch.float32, device=dev)

    tcls = targets[..., 0].reshape(nt)
    gxy = targets[..., 1:3].reshape(nt, 2) * gain
    twh = targets[..., 3:5].reshape(nt, 2) * gain
    b_idx = torch.arange(bs, device=dev).repeat_interleave(M)
    t_idx = torch.arange(M, device=dev).repeat(bs)

    # anchor-ratio compatibility (na, nt)
    r = twh[None] / anchors_l[:, None]
    base = tmask.reshape(nt)[None] & (torch.maximum(r, 1.0 / r).amax(-1) < anchor_t)

    # neighbour-cell selection: the neighbours within `bias` of a cell
    gxi = gain - gxy
    jj = (gxy[:, 0] % 1 < bias) & (gxy[:, 0] > 1)
    kk = (gxy[:, 1] % 1 < bias) & (gxy[:, 1] > 1)
    ll = (gxi[:, 0] % 1 < bias) & (gxi[:, 0] > 1)
    mm = (gxi[:, 1] % 1 < bias) & (gxi[:, 1] > 1)
    sel = torch.stack([torch.ones_like(jj), jj, kk, ll, mm])            # (5, nt)
    valid = (sel[:, None] & base[None]).reshape(-1)                     # (5·na·nt,)

    off = torch.from_numpy(_OFFSETS).to(dev) * (bias / 0.5)             # (5, 2)
    gij = torch.floor(gxy[None] - off[:, None])                         # (5, nt, 2)
    gi = gij[..., 0].clamp(0, nx - 1).long()
    gj = gij[..., 1].clamp(0, ny - 1).long()

    def bcast(x):  # (nt,) per target or (5, nt) per (offset, target) -> (5·na·nt,)
        x = x[None, None] if x.ndim == 1 else x[:, None]
        return x.expand(5, na, nt).reshape(-1)

    def bcast2(x):  # (nt, 2) or (5, nt, 2) -> (5·na·nt, 2)
        x = x[None, None] if x.ndim == 2 else x[:, None]
        return x.expand(5, na, nt, 2).reshape(-1, 2)

    a = torch.arange(na, device=dev)[None, :, None].expand(5, na, nt).reshape(-1)
    return Assignment(
        b=bcast(b_idx), a=a, gj=bcast(gj), gi=bcast(gi),
        tbox=torch.cat([bcast2(gxy[None] - gij), bcast2(twh)], 1),
        cls=bcast(tcls.long()), tidx=bcast(t_idx),
        xywhn=torch.cat([bcast2(gxy) / gain, bcast2(twh) / gain], 1),
        anch=anchors_l[a], valid=valid)


class ComputeLoss:
    """Detection loss (JAX losses/detect.py:140-220; reference
    utils/loss.py:91-168). Call with the raw level maps (bs, na, ny, nx, no)
    and padded targets; returns (loss · bs, [lbox, lobj, lcls])."""

    def __init__(self, anchors, strides: Sequence[int], nc: int, hyp: Dict):
        anchors = np.asarray(anchors, np.float32).reshape(len(strides), -1, 2)
        self.anchors_grid = torch.from_numpy(anchors / np.asarray(strides, np.float32)[:, None, None])
        self.nc = int(nc)
        self.nl = len(strides)
        self.na = anchors.shape[1]
        self.hyp = dict(hyp)
        self.balance = {3: [4.0, 1.0, 0.4]}.get(self.nl, [4.0, 1.0, 0.25, 0.06, 0.02])
        self.cp, self.cn = smooth_bce(self.hyp.get("label_smoothing", 0.0))

    def _assign(self, i, pi, targets, tmask) -> Assignment:
        _, _, ny, nx, _ = pi.shape
        return build_targets_level(targets, tmask, self.anchors_grid[i].to(pi.device), ny, nx,
                                   self.hyp.get("anchor_t", 4.0))

    def _bce(self, x, t, pos_weight):
        g = self.hyp.get("fl_gamma", 0.0)
        if g > 0:
            return focal_bce_with_logits(x, t, pos_weight, gamma=g)
        return bce_with_logits(x, t, pos_weight)

    def _cls_obj_box(self, pi, asgn: Assignment):
        """One level's box and class losses and objectness target map:
        (lbox, lcls, tobj (bs, na, ny, nx))."""
        bs, na, ny, nx, _ = pi.shape
        rows = pi[asgn.b, asgn.a, asgn.gj, asgn.gi]                          # (K, no)
        n_pos = global_sum(asgn.valid.sum()).clamp(min=1).to(pi.dtype)

        pxy = torch.sigmoid(rows[:, 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(rows[:, 2:4]) * 2.0) ** 2 * asgn.anch
        iou = bbox_iou(torch.cat([pxy, pwh], 1), asgn.tbox, xywh=True, CIoU=True)[:, 0]
        lbox = torch.where(asgn.valid, 1.0 - iou, 0.0).sum() / n_pos

        iou_d = iou.detach().clamp(min=0.0)  # the reference's gr = 1: the IoU itself
        flat = ((asgn.b * na + asgn.a) * ny + asgn.gj) * nx + asgn.gi
        vals = torch.where(asgn.valid, iou_d, -1.0).to(pi.dtype)
        tobj = torch.zeros(bs * na * ny * nx, dtype=pi.dtype, device=pi.device) \
            .scatter_reduce_(0, flat, vals, "amax", include_self=True)
        tobj = tobj.clamp(min=0.0).reshape(bs, na, ny, nx)

        lcls = torch.zeros((), dtype=pi.dtype, device=pi.device)
        if self.nc > 1:
            pcls = rows[:, 5:5 + self.nc]
            t = torch.full_like(pcls, self.cn)
            t[torch.arange(t.shape[0], device=t.device), asgn.cls] = self.cp
            bce = self._bce(pcls, t, self.hyp.get("cls_pw", 1.0))
            lcls = torch.where(asgn.valid[:, None], bce, 0.0).sum() / (n_pos * self.nc)
        return lbox, lcls, tobj

    def __call__(self, p: Sequence[torch.Tensor], targets: torch.Tensor, tmask: torch.Tensor):
        h = self.hyp
        bs = int(global_sum(torch.tensor(p[0].shape[0])))
        lbox = lobj = lcls = 0.0
        for i, pi in enumerate(p):
            lb, lc, tobj = self._cls_obj_box(pi, self._assign(i, pi, targets, tmask))
            lbox = lbox + lb
            lcls = lcls + lc
            lobj = lobj + mean_share(self._bce(pi[..., 4], tobj, h.get("obj_pw", 1.0))) \
                * self.balance[i]
        lbox = lbox * h.get("box", 0.05)
        lobj = lobj * h.get("obj", 1.0)
        lcls = lcls * h.get("cls", 0.5)
        return (lbox + lobj + lcls) * bs, torch.stack([lbox, lobj, lcls]).detach()
