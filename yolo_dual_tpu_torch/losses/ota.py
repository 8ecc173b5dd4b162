"""SimOTA and AuxOTA detection losses (port of yolo_dual_tpu/losses/ota.py;
reference utils/loss_OTA.py:233-520 and utils/loss_AuxOTA.py:238-758).

The candidates are build_targets_level's dense lattice over the levels,
compacted per image to a static capacity C, so no shape depends on the data
and nothing waits on the card. The assignment is batched over the images:

- compaction: the image's valid candidates in index order, then its others
  in index order, the first C kept and sorted by index (lax.top_k over the
  validity, then sort, as JAX does);
- cost = the class cost + 3 · -log(IoU + 1e-8), where the class cost of a
  candidate against a gt is sum_j BCE(z_j, onehot(gt)_j), z = logit of
  sqrt(σ(cls)·σ(obj)), written as A[cand] + B[cand, gt class] so the
  (M, C, nc) tensor is never built;
- dynamic k = the integer part of the sum of a gt's top-k IoUs (at least 1),
  the gt's k cheapest candidates in ascending cost, equal costs in ascending
  index (a stable sort: lax.top_k's tie order, ROADMAP §C C1);
- a candidate that several gts match goes to the gt of least cost, the
  first on ties (argmin), even one whose own top k did not take it.

The assignment carries no gradient; the loss rows do. AuxOTA assigns its aux
branch from the lead head's predictions (bias-1.0 candidates, top-20
dynamic k) and reads the loss from the aux head at those sites, at weight
0.25.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from yolo_dual_tpu_torch.losses.detect import ComputeLoss, bce_with_logits, build_targets_level
from yolo_dual_tpu_torch.ops.boxes import bbox_iou, box_iou, xywh2xyxy
from yolo_dual_tpu_torch.parallel.mesh import global_sum, mean_share

BIG_COST = 1e9  # the cost of a (gt, candidate) pair that is not valid


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus as jax.nn.softplus writes it, logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class ComputeLossOTA(ComputeLoss):
    """SimOTA loss (JAX losses/ota.py:52). Call with the raw level maps
    (bs, na, ny, nx, no), padded targets (bs, M, 5), their mask (bs, M) and
    optionally the input's pixel scale (an int, or [W, H, W, H]); returns
    (loss · bs, [lbox, lobj, lcls])."""

    def __init__(self, anchors, strides: Sequence[int], nc: int, hyp: Dict,
                 top_k: int = 10):
        super().__init__(anchors, strides, nc, hyp)
        self.strides = tuple(int(s) for s in strides)
        self.top_k = top_k

    def _pixel_scale(self, p) -> torch.Tensor:
        """[W, H, W, H] of the input, from the first level's grid and stride,
        so GT boxes of a non-square input scale into the candidates' pixels."""
        ny, nx = p[0].shape[2], p[0].shape[3]
        s = float(self.strides[0])
        return torch.tensor([nx * s, ny * s, nx * s, ny * s], dtype=torch.float32,
                            device=p[0].device)

    def _simota_select(self, p, targets, tmask, imgsz, bias: float = 0.5,
                       loss_rows_from=None) -> dict:
        """The per-image assignment (JAX losses/ota.py:72): `idxs` (bs, C)
        candidate indices, `fgs` (bs, C) and `matched_gts` (bs, C), with the
        concatenated lattice (`b`, `a`, `gj`, `gi`, `anch`, `lvl`) and the
        candidates' rows of `p` (`rows`) and of `loss_rows_from`
        (`loss_rows`, the rows of `p` without it)."""
        bs, M = tmask.shape
        dev = p[0].device
        asgns = [build_targets_level(targets, tmask, self.anchors_grid[i].to(dev), pi.shape[2],
                                     pi.shape[3], self.hyp.get("anchor_t", 4.0), bias=bias)
                 for i, pi in enumerate(p)]
        cat = {k: torch.cat([getattr(a, k) for a in asgns]) for k in ("b", "a", "gj", "gi", "anch",
                                                                      "valid")}
        cat["lvl"] = torch.cat([torch.full_like(a.valid, i, dtype=torch.long)
                                for i, a in enumerate(asgns)])
        K = cat["valid"].shape[0]
        # each gt reaches at most 3 cells (bias 0.5) or 5 (bias 1.0) a level and anchor, so
        # this capacity drops no valid candidate
        cells = 5 if bias >= 1.0 else 3
        C = min(K // bs, cells * self.na * len(p) * M)
        rows = torch.cat([pi[a.b, a.a, a.gj, a.gi] for pi, a in zip(p, asgns)])
        loss_rows = rows if loss_rows_from is None else torch.cat(
            [pi[a.b, a.a, a.gj, a.gi] for pi, a in zip(loss_rows_from, asgns)])

        with torch.no_grad():
            r = rows.detach().float()
            stride = torch.tensor(self.strides, dtype=torch.float32,
                                  device=dev)[cat["lvl"]][:, None]
            grid = torch.stack([cat["gi"].float(), cat["gj"].float()], 1)
            pxy = (torch.sigmoid(r[:, :2]) * 2.0 - 0.5 + grid) * stride
            pwh = (torch.sigmoid(r[:, 2:4]) * 2.0) ** 2 * cat["anch"] * stride
            pxyxy = xywh2xyxy(torch.cat([pxy, pwh], 1))

            # compaction: each image's valid candidates first, both groups in index order
            mine = (cat["b"][None] == torch.arange(bs, device=dev)[:, None]) & cat["valid"][None]
            order = torch.sort(mine.to(torch.uint8), dim=1, descending=True, stable=True).indices
            idxs = order[:, :C].sort(dim=1).values                          # (bs, C)
            cvalid = mine.gather(1, idxs)

            scale = torch.as_tensor(imgsz, dtype=torch.float32, device=dev)
            txyxy = xywh2xyxy(targets[..., 1:5].float() * scale)            # (bs, M, 4)
            pair_valid = tmask.bool()[:, :, None] & cvalid[:, None, :]      # (bs, M, C)
            iou = torch.where(pair_valid, box_iou(txyxy, pxyxy[idxs]), 0.0)
            iou_loss = -torch.log(iou + 1e-8)
            kk = min(self.top_k, C)
            dynamic_k = iou.sort(dim=2, descending=True).values[..., :kk].sum(2) \
                .to(torch.int32).clamp(min=1)                               # (bs, M)

            # the class cost without the (M, C, nc) tensor
            rc = r[idxs]                                                    # (bs, C, no)
            y = torch.sqrt(torch.sigmoid(rc[..., 5:5 + self.nc])
                           * torch.sigmoid(rc[..., 4])[..., None]).clamp(1e-7, 1 - 1e-7)
            z = torch.log(y / (1 - y))
            sp_neg = _softplus(z)                                           # BCE at target 0
            a_cost = sp_neg.sum(-1)                                         # (bs, C)
            b_cost = _softplus(-z) - sp_neg                                 # (bs, C, nc)
            gt_cls = targets[..., 0].long().clamp(0, self.nc - 1)           # (bs, M)
            cls_cost = a_cost[:, None, :] + b_cost.gather(
                2, gt_cls[:, None, :].expand(bs, C, M)).transpose(1, 2)
            cost = torch.where(pair_valid, cls_cost + 3.0 * iou_loss, BIG_COST)

            # dynamic k: each gt's k cheapest candidates, equal costs in index order
            cheapest = torch.sort(cost, dim=2, stable=True).indices[..., :kk]
            take = torch.arange(kk, device=dev) < dynamic_k[..., None]
            matching = torch.zeros(bs, M, C, dtype=torch.bool, device=dev) \
                .scatter_(2, cheapest, take) & pair_valid
            # a candidate several gts took goes to the gt of least cost
            best = torch.arange(M, device=dev)[None, :, None] == cost.argmin(1)[:, None, :]
            matching = torch.where(matching.sum(1, keepdim=True) > 1, best, matching)
            fgs = matching.any(1)
            matched_gts = matching.to(torch.uint8).argmax(1)
        return {"idxs": idxs, "fgs": fgs, "matched_gts": matched_gts, "rows": rows,
                "loss_rows": loss_rows, **cat}

    def _loss(self, p, sel: dict, rows: torch.Tensor, targets: torch.Tensor):
        """lbox, lobj, lcls of the maps `p` at the assignment `sel`, the
        candidates' rows `rows` (JAX losses/ota.py:201-256)."""
        h = self.hyp
        bs = p[0].shape[0]
        flat_idx = sel["idxs"].reshape(-1)
        fg = sel["fgs"].reshape(-1)
        img_of = torch.arange(bs, device=fg.device).repeat_interleave(sel["idxs"].shape[1])
        cand_rows = rows[flat_idx]
        cb, ca, cgj, cgi = (sel[k][flat_idx] for k in ("b", "a", "gj", "gi"))
        canch, clvl = sel["anch"][flat_idx], sel["lvl"][flat_idx]
        gt = targets[img_of, sel["matched_gts"].reshape(-1)]
        gt_cls = gt[:, 0].long()
        lbox = lobj = lcls = torch.zeros((), dtype=p[0].dtype, device=fg.device)
        for i, pi in enumerate(p):
            _, na, ny, nx, _ = pi.shape
            mine = fg & (clvl == i)
            n_pos = global_sum(mine.sum()).clamp(min=1).to(pi.dtype)
            pxy = torch.sigmoid(cand_rows[:, :2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(cand_rows[:, 2:4]) * 2.0) ** 2 * canch
            gain = torch.tensor([nx, ny, nx, ny], dtype=torch.float32, device=fg.device)
            tb = gt[:, 1:5] * gain
            tb = torch.cat([tb[:, :2] - torch.stack([cgi, cgj], 1).float(), tb[:, 2:]], 1)
            iou = bbox_iou(torch.cat([pxy, pwh], 1), tb, xywh=True, CIoU=True)[:, 0]
            lbox = lbox + torch.where(mine, 1.0 - iou, 0.0).sum() / n_pos

            flat = ((cb * na + ca) * ny + cgj) * nx + cgi
            vals = torch.where(mine, iou.detach().clamp(min=0.0), -1.0).to(pi.dtype)
            tobj = torch.zeros(bs * na * ny * nx, dtype=pi.dtype, device=pi.device) \
                .scatter_reduce_(0, torch.where(mine, flat, 0), vals, "amax", include_self=True)
            tobj = tobj.clamp(min=0.0).reshape(bs, na, ny, nx)
            lobj = lobj + mean_share(bce_with_logits(pi[..., 4], tobj, h.get("obj_pw", 1.0))) \
                * self.balance[i]
            if self.nc > 1:
                pcls = cand_rows[:, 5:5 + self.nc]
                t = torch.full_like(pcls, self.cn)
                t[torch.arange(t.shape[0], device=t.device), gt_cls] = self.cp
                bce = bce_with_logits(pcls, t, h.get("cls_pw", 1.0))
                lcls = lcls + torch.where(mine[:, None], bce, 0.0).sum() / (n_pos * self.nc)
        lbox = lbox * h.get("box", 0.05)
        lobj = lobj * h.get("obj", 1.0)
        lcls = lcls * h.get("cls", 0.5)
        bs = int(global_sum(torch.tensor(bs)))
        return (lbox + lobj + lcls) * bs, torch.stack([lbox, lobj, lcls]).detach()

    def __call__(self, p: Sequence[torch.Tensor], targets: torch.Tensor, tmask: torch.Tensor,
                 imgsz=None):
        if imgsz is None:
            imgsz = self._pixel_scale(p)
        sel = self._simota_select(p, targets, tmask, imgsz)
        return self._loss(p, sel, sel["rows"], targets)


class ComputeLossAuxOTA(ComputeLossOTA):
    """Dual-head OTA loss (JAX losses/ota.py:262): the first nl maps are the
    lead head (top-20 dynamic k, bias 0.5), the next nl the aux head, whose
    bias-1.0 candidates are assigned from the lead head's predictions and
    whose loss, read from the aux maps at those sites, counts 0.25."""

    AUX_WEIGHT = 0.25

    def __init__(self, anchors, strides, nc, hyp):
        super().__init__(anchors, strides, nc, hyp, top_k=20)

    def __call__(self, p, targets, tmask, imgsz=None):
        if imgsz is None:
            imgsz = self._pixel_scale(p)
        lead, aux = list(p[:self.nl]), list(p[self.nl:])
        lead_loss, lead_items = ComputeLossOTA.__call__(self, lead, targets, tmask, imgsz)
        sel = self._simota_select(lead, targets, tmask, imgsz, bias=1.0, loss_rows_from=aux)
        aux_loss, aux_items = self._loss(aux, sel, sel["loss_rows"], targets)
        return lead_loss + self.AUX_WEIGHT * aux_loss, lead_items + self.AUX_WEIGHT * aux_items
