"""Instance-segmentation loss: the detection loss plus the prototype-mask
branch (port of yolo_dual_tpu/losses/segment.py; reference
utils/segment/loss.py:12-186).

Protos are the port's NCHW (bs, nm, mh, mw). The mask branch runs on the
valid candidates compacted per image to a fixed capacity, 3 · na · M, which
holds every positive (at most 3 of the 5 offset cells are selected per
target), so the proto product is one batched matmul. GT masks are
one overlap-indexed plane per image (instance i has value i + 1) when
overlap=True, else (bs, M, h, w) binary planes; either is resized to the proto
size by nearest neighbour with half-pixel centres.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_dual_tpu_torch.losses.detect import Assignment, ComputeLoss, bce_with_logits
from yolo_dual_tpu_torch.ops.boxes import xywh2xyxy
from yolo_dual_tpu_torch.ops.mask_ops import crop_mask
from yolo_dual_tpu_torch.parallel.mesh import global_sum, mean_share


def _compact_per_image(asgn: Assignment, bs: int, capacity: int):
    """(bs, capacity) indices into the dense lattice and their validity: per
    image the first `capacity` valid candidates in lattice order, padded with
    the first invalid ones, in ascending order. JAX selects with lax.top_k,
    which keeps the lowest index among ties; a stable sort of the validity
    gives the same set (torch.topk promises no tie order)."""
    mine = (asgn.b[None] == torch.arange(bs, device=asgn.b.device)[:, None]) & asgn.valid[None]
    order = torch.sort((~mine).to(torch.uint8), dim=1, stable=True).indices[:, :capacity]
    idx = order.sort(dim=1).values
    return idx, torch.gather(mine, 1, idx)


class ComputeSegmentLoss(ComputeLoss):
    """Loss for the (raw levels, protos) output of a Segment model in
    training. Returns (loss · bs, [lbox, lseg, lobj, lcls]); inside
    parallel/mesh.py:across, this rank's share of them (losses/detect.py)."""

    def __init__(self, anchors, strides: Sequence[int], nc: int, nm: int, hyp: Dict,
                 overlap: bool = True):
        super().__init__(anchors, strides, nc, hyp)
        self.nm = int(nm)
        self.overlap = overlap

    def __call__(self, preds, targets: torch.Tensor, tmask: torch.Tensor, masks: torch.Tensor):
        p, proto = preds
        bs, nm, mh, mw = proto.shape
        h = self.hyp
        lbox = lobj = lcls = lseg = 0.0
        capacity = 3 * self.na * targets.shape[1]

        # GT masks at proto resolution (reference: F.interpolate nearest)
        if masks.shape[-2:] != (mh, mw):
            lead = masks.shape[:-2]
            masks = F.interpolate(masks.float().reshape(-1, 1, *masks.shape[-2:]), size=(mh, mw),
                                  mode="nearest-exact").reshape(*lead, mh, mw)
        scalev = torch.tensor([mw, mh, mw, mh], dtype=torch.float32, device=proto.device)

        for i, pi in enumerate(p):
            asgn = self._assign(i, pi, targets, tmask)
            lb, lc, tobj = self._cls_obj_box(pi, asgn)
            lbox = lbox + lb
            lcls = lcls + lc
            lobj = lobj + mean_share(bce_with_logits(pi[..., 4], tobj, h.get("obj_pw", 1.0))) \
                * self.balance[i]

            # mask branch on the per-image compacted positives
            idx, val = _compact_per_image(asgn, bs, capacity)                 # (bs, C)
            rows = pi[asgn.b[idx], asgn.a[idx], asgn.gj[idx], asgn.gi[idx]]
            pmask = rows[..., 5 + self.nc: 5 + self.nc + self.nm]             # (bs, C, nm)
            tidx = asgn.tidx[idx]
            xywhn = asgn.xywhn[idx]                                            # (bs, C, 4)
            pred = torch.einsum("bkn,bnhw->bkhw", pmask, proto)
            if self.overlap:
                gt = (masks[:, None] == (tidx + 1)[..., None, None].to(masks.dtype)).to(pred.dtype)
            else:
                gt = masks[torch.arange(bs, device=masks.device)[:, None], tidx].to(pred.dtype)
            marea = xywhn[..., 2] * xywhn[..., 3]
            mxyxy = xywh2xyxy(xywhn * scalev)
            bce = bce_with_logits(pred, gt)
            crop = crop_mask(bce.reshape(-1, mh, mw), mxyxy.reshape(-1, 4)).reshape(bce.shape)
            per = crop.mean(dim=(2, 3)) / marea.clamp(min=1e-9)
            acc = torch.where(val, per, 0.0).sum(1)                            # (bs,)
            # per-image mean over instances, summed over images (reference :89-95)
            lseg = lseg + (acc / val.sum(1).clamp(min=1).to(acc.dtype)).sum()

        lbox = lbox * h.get("box", 0.05)
        lobj = lobj * h.get("obj", 1.0)
        lcls = lcls * h.get("cls", 0.5)
        bs = int(global_sum(torch.tensor(bs)))  # the global batch under a mesh, as JAX's
        lseg = lseg * h.get("box", 0.05) / bs
        loss = lbox + lobj + lcls + lseg
        return loss * bs, torch.stack([lbox, lseg, lobj, lcls]).detach()


def encode_overlap_masks(instance_masks: np.ndarray):
    """(n, h, w) binary instance masks -> ((h, w) overlap-indexed plane, with
    value rank + 1, and the area-sort order). Larger instances are written
    first so smaller ones win overlaps (reference
    utils/segment/dataloaders.py:309-331)."""
    n, hgt, wid = instance_masks.shape
    out = np.zeros((hgt, wid), np.float32)
    order = np.argsort(-instance_masks.reshape(n, -1).sum(1))
    for rank, i in enumerate(order):
        out[instance_masks[i] > 0] = rank + 1
    return out, order
