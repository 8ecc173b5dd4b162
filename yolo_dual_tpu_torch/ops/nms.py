"""Batched fixed-shape NMS (port of yolo_dual_tpu/ops/nms.py:nms_from_raw, its
serving and multi-label branches; reference utils/general.py:886-1001).

torchvision is not a dependency, so the greedy NMS is the package's own: the
matrix fixpoint of `nms_padded_cluster`, batched. It resolves the greedy order
on the ≤ pre_nms_topk candidates with one host synchronization per fixpoint
sweep (the depth of the longest suppression chain), not one per selection.
Candidates are ranked as `lax.top_k` ranks them: by score, equal scores in
ascending index order, indices running over levels, then y, x, anchor (and
class, multi-label), as the JAX package flattens them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from yolo_dual_tpu_torch.ops.boxes import box_iou, xywh2xyxy

MAX_WH = 7680  # class-offset multiplier, same constant as the reference
IOU_CHUNK = 1 << 25  # elements of a float IoU block: (images, n, n) built a few images at a time


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> torch.Tensor:
    """Exact greedy NMS with a fixed output shape, batched.

    boxes: (bs, N, 4) xyxy (already class-offset for batched NMS); scores:
    (bs, N), candidates with score <= 0 are invalid. Returns keep indices
    (bs, max_det) int64, -1 padded, in descending score order, equal scores
    in ascending index order.

    A box j is kept iff no kept box of higher score has IoU > iou_thres with it
    (strictly greater, as torchvision). Iterating keep ← valid ∧ ¬∃i (keep[i] ∧
    A[i, j]) over score order reaches that unique fixpoint in at most
    chain-depth sweeps (Cluster-NMS, Zheng et al. 2020). The (bs, N, N)
    suppression matrix is boolean; its float IoUs are built IOU_CHUNK
    elements at a time.
    """
    bs, n = scores.shape
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    b = boxes.gather(1, order[..., None].expand(bs, n, 4))
    valid = scores.gather(1, order) > 0
    upper = torch.ones(n, n, dtype=torch.bool, device=scores.device).triu(1)
    sup = torch.empty(bs, n, n, dtype=torch.bool, device=scores.device)   # kept i suppresses j
    step = max(1, IOU_CHUNK // (n * n))
    for i in range(0, bs, step):
        bi = b[i:i + step]
        torch.gt(box_iou(bi, bi), iou_thres, out=sup[i:i + step])
    sup &= upper
    sup &= valid[:, :, None]
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
                 iou_thres: float = 0.45, multi_label: bool = False, agnostic: bool = False,
                 max_det: int = 300, nm: int = 0, pre_nms_topk: int = 1024,
                 classes_mask: Optional[torch.Tensor] = None):
    """Fused decode + NMS straight off the raw head maps (JAX nms_from_raw).

    Serving branch (multi_label=False or one class): confidences are reduced
    per level off the raw logits, one label per box. Multi-label branch (the
    validator's): every (candidate, class) score sigmoid(obj) * sigmoid(cls)
    in float32 above conf_thres competes. Either way the top `pre_nms_topk`
    scores are taken, and only those rows are gathered and decoded. The mask coefficients are scaled by the objectness, as the
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
    multi = multi_label and nc > 1
    bs = raw[0].shape[0]
    device = raw[0].device
    conf_ls = []
    for p in raw:
        obj = p[..., 4].float().sigmoid()
        cls = p[..., 5:5 + nc]
        if classes_mask is not None:
            cls = cls.masked_fill(~classes_mask, -1e4)
        if multi:
            c = cls.float().sigmoid() * obj[..., None]
            c = torch.where(c > conf_thres, c, 0.0)
        else:
            c = cls.amax(-1).float().sigmoid() * obj
            c = torch.where((c > conf_thres) & (obj > conf_thres), c, 0.0)
        conf_ls.append(c.movedim(1, 3).reshape(bs, -1))                    # y, x, anchor(, class)
    conf = torch.cat(conf_ls, 1)
    k = min(pre_nms_topk, conf.shape[1])
    # lax.top_k's order: torch.topk fixes none among equal scores, which saturated
    # logits (1.0) and the zeros below conf_thres make common
    scores, idx = (t[:, :k] for t in conf.sort(dim=1, descending=True, stable=True))
    scores = torch.where(scores > conf_thres, scores, 0.0)
    cand = idx // nc if multi else idx

    rows = torch.zeros(bs, k, no, device=device)
    box = torch.zeros(bs, k, 4, device=device)
    bidx = torch.arange(bs, device=device)[:, None]
    off = 0
    for p, anchor, s in zip(raw, anchors, strides):
        _, na, ny, nx, _ = p.shape
        nl = na * ny * nx
        in_level = ((cand >= off) & (cand < off + nl))[..., None]
        il = (cand - off).clamp(0, nl - 1)
        a, yx = il % na, il // na
        q = p.permute(0, 1, 4, 2, 3).reshape(bs, na, no, ny * nx)         # the conv output layout
        rl = q[bidx, a, :, yx].float()                                      # (bs, k, no)
        g = torch.stack([(yx % nx).float(), (yx // nx).float()], -1) - 0.5
        anc = torch.tensor(anchor, dtype=torch.float32, device=device).view(na, 2)[a]
        xy = (rl[..., :2].sigmoid() * 2 + g) * float(s)
        wh = (rl[..., 2:4].sigmoid() * 2) ** 2 * anc
        rows = torch.where(in_level, rl, rows)
        box = torch.where(in_level, xywh2xyxy(torch.cat([xy, wh], -1)), box)
        off += nl
    if multi:
        cj = (idx % nc).float()
    else:
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
