"""Batched fixed-shape NMS (port of the serving branch of yolo_dual_tpu/ops/nms.py;
reference utils/general.py:886-1001).

torchvision is not a dependency, so the greedy NMS is the package's own: the
matrix fixpoint of `nms_padded_cluster`, batched. It resolves the greedy order
on the ≤ pre_nms_topk candidates with one host synchronization per fixpoint
sweep (the depth of the longest suppression chain), not one per selection.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from yolo_dual_tpu_torch.ops.boxes import box_iou, xywh2xyxy

MAX_WH = 7680  # class-offset multiplier, same constant as the reference


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> torch.Tensor:
    """Exact greedy NMS with a fixed output shape, batched.

    boxes: (bs, N, 4) xyxy (already class-offset for batched NMS); scores:
    (bs, N), candidates with score <= 0 are invalid. Returns keep indices
    (bs, max_det) int64, -1 padded, in descending score order.

    A box j is kept iff no kept box of higher score has IoU > iou_thres with it
    (strictly greater, as torchvision). Iterating keep ← valid ∧ ¬∃i (keep[i] ∧
    A[i, j]) over score order reaches that unique fixpoint in at most
    chain-depth sweeps (Cluster-NMS, Zheng et al. 2020).
    """
    bs, n = scores.shape
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    b = boxes.gather(1, order[..., None].expand(bs, n, 4))
    valid = scores.gather(1, order) > 0
    upper = torch.ones(n, n, dtype=torch.bool, device=scores.device).triu(1)
    sup = (box_iou(b, b) > iou_thres) & upper & valid[:, :, None]   # kept i suppresses j
    keep = valid
    for _ in range(n):
        new = valid & ~(sup & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    ar = torch.arange(n, device=scores.device)
    key = torch.where(keep, ar, n).sort(1).values
    if n < max_det:
        key = torch.cat([key, key.new_full((bs, max_det - n), n)], 1)
    first = key[:, :max_det]
    return torch.where(first < n, order.gather(1, first.clamp(max=n - 1)), -1)


def nms_from_raw(raw: Sequence[torch.Tensor], anchors, strides, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, agnostic: bool = False, max_det: int = 300,
                 nm: int = 0, pre_nms_topk: int = 1024,
                 classes_mask: Optional[torch.Tensor] = None):
    """Fused decode + NMS straight off the raw head maps, serving branch
    (one label per box; JAX nms_from_raw with multi_label=False).

    Confidences are reduced per level off the raw logits, the top
    `pre_nms_topk` candidates are taken, and only those rows are gathered and
    decoded. The mask coefficients are scaled by the objectness, as the
    reference NMS does (utils/general.py:949).

    raw: list of (bs, na, ny, nx, 5+nc+nm) per level (heads.py layout).
    anchors/strides: the head's config. classes_mask: optional (nc,) bool.
    Returns (out (bs, max_det, 6+nm) rows [xyxy, conf, cls, mask...], n_valid (bs,) int32).
    """
    no = raw[0].shape[-1]
    nc = no - nm - 5
    if nc < 1:
        raise ValueError(f"raw head maps have {no} channels but nm={nm} implies {nc} classes; "
                         "pass the model's nm")
    bs = raw[0].shape[0]
    device = raw[0].device
    conf_ls = []
    for p in raw:
        obj = p[..., 4].float().sigmoid()
        cls = p[..., 5:5 + nc]
        if classes_mask is not None:
            cls = cls.masked_fill(~classes_mask, -1e4)
        c = cls.amax(-1).float().sigmoid() * obj
        conf_ls.append(torch.where((c > conf_thres) & (obj > conf_thres), c, 0.0).reshape(bs, -1))
    conf = torch.cat(conf_ls, 1)                                            # (bs, N), "ayx" order
    k = min(pre_nms_topk, conf.shape[1])
    scores, cand = conf.topk(k, dim=1)
    scores = torch.where(scores > conf_thres, scores, 0.0)

    rows = torch.zeros(bs, k, no, device=device)
    box = torch.zeros(bs, k, 4, device=device)
    bidx = torch.arange(bs, device=device)[:, None]
    off = 0
    for p, anchor, s in zip(raw, anchors, strides):
        _, na, ny, nx, _ = p.shape
        nl = na * ny * nx
        in_level = ((cand >= off) & (cand < off + nl))[..., None]
        il = (cand - off).clamp(0, nl - 1)
        a, yx = il // (ny * nx), il % (ny * nx)
        q = p.permute(0, 1, 4, 2, 3).reshape(bs, na, no, ny * nx)         # the conv output layout
        rl = q[bidx, a, :, yx].float()                                      # (bs, k, no)
        g = torch.stack([(yx % nx).float(), (yx // nx).float()], -1) - 0.5
        anc = torch.tensor(anchor, dtype=torch.float32, device=device).view(na, 2)[a]
        xy = (rl[..., :2].sigmoid() * 2 + g) * float(s)
        wh = (rl[..., 2:4].sigmoid() * 2) ** 2 * anc
        rows = torch.where(in_level, rl, rows)
        box = torch.where(in_level, xywh2xyxy(torch.cat([xy, wh], -1)), box)
        off += nl
    cls_sel = rows[..., 5:5 + nc]
    if classes_mask is not None:
        cls_sel = cls_sel.masked_fill(~classes_mask, -1e4)
    cj = cls_sel.argmax(-1).float()
    mask = rows[..., 5 + nc:] * rows[..., 4:5].sigmoid()

    nms_box = box if agnostic else box + (cj * MAX_WH)[..., None]
    keep = nms_padded(nms_box, scores, iou_thres, max_det)
    valid = keep >= 0
    safe = keep.clamp(min=0)
    out = torch.cat([box.gather(1, safe[..., None].expand(-1, -1, 4)),
                     scores.gather(1, safe)[..., None], cj.gather(1, safe)[..., None],
                     mask.gather(1, safe[..., None].expand(-1, -1, nm))], -1)
    out = torch.where(valid[..., None], out, 0.0)
    return out, valid.sum(1).to(torch.int32)
