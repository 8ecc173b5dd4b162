"""Batched fixed-shape NMS (port of yolo_dual_tpu/ops/nms.py: nms_from_raw,
nms_batched, soft_nms_padded and non_max_suppression; reference
utils/general.py:886-1001, utils/general-softnms.py:938-1096).

torchvision is not a dependency, so the greedy NMS is the package's own: the
matrix fixpoint of `nms_padded_cluster`, batched. It resolves the greedy order
on the ≤ pre_nms_topk candidates with one host synchronization per fixpoint
sweep (the depth of the longest suppression chain), not one per selection.
Candidates are ranked as `lax.top_k` ranks them: by score, equal scores in
ascending index order, indices running over levels, then y, x, anchor (and
class, multi-label), as the JAX package flattens them. The Gaussian soft-NMS
(`soft_nms_padded`) is a loop of selections, batched over the images.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from yolo_dual_tpu_torch.ops.boxes import box_iou, xywh2xyxy

MAX_WH = 7680  # class-offset multiplier, same constant as the reference
IOU_CHUNK = 1 << 25  # elements of a float IoU block: (images, n, n) built a few images at a time
SOFT_NMS_SIGMA = 0.5  # Gaussian soft-NMS decay exp(-IoU²/sigma): soft_nms_padded's default, JAX's


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


def _iou_one_vs_many(box: torch.Tensor, boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU of each image's one xyxy box (bs, 4) against its boxes (bs, N, 4),
    in JAX's order of operations (JAX ops/nms.py:_iou_one_vs_many)."""
    b = box[:, None]
    inter = (torch.minimum(b[..., 2], boxes[..., 2]) - torch.maximum(b[..., 0], boxes[..., 0])
             ).clamp(min=0) * (torch.minimum(b[..., 3], boxes[..., 3])
                               - torch.maximum(b[..., 1], boxes[..., 1])).clamp(min=0)
    a1 = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    a2 = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return inter / (a1 + a2 - inter + eps)


def soft_nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int,
                    sigma: float = SOFT_NMS_SIGMA, score_threshold: float = 0.25):
    """Gaussian soft-NMS, batched (JAX ops/nms.py:217; reference
    utils/general-softnms.py:938-967): take the best remaining score (the
    first on ties), keep it with its score at that moment, decay the scores
    of the boxes whose IoU with it exceeds iou_thres by exp(-IoU²/sigma),
    and stop an image once its best remaining score is at most
    score_threshold. boxes (bs, N, 4) xyxy, class-offset; scores (bs, N) ≥ 0.

    Scores only fall, so an image that stops stays stopped and keeps at most
    as many boxes as it has scores above score_threshold at the start: the
    loop runs that many masked steps (at most max_det), with one host
    synchronization for the count, none a step. Returns (keep (bs, max_det)
    int64, -1 padded, the kept scores (bs, max_det))."""
    bs = scores.shape[0]
    rows = torch.arange(bs, device=scores.device)
    cur = scores.clone()
    keep = torch.full((bs, max_det), -1, dtype=torch.long, device=scores.device)
    kept = torch.zeros(bs, max_det, dtype=scores.dtype, device=scores.device)
    steps = min(max_det, int((scores > score_threshold).sum(1).max())) if bs else 0
    for k in range(steps):
        best, i = cur.max(1)
        going = best > score_threshold
        keep[:, k] = torch.where(going, i, -1)
        kept[:, k] = torch.where(going, best, 0.0)
        iou = _iou_one_vs_many(boxes[rows, i], boxes)
        cur = cur * torch.where(iou > iou_thres, torch.exp(-(iou ** 2) / sigma), 1.0)
        cur[rows, i] = -1.0
    return keep, kept


def _nms_rows(box, scores, cj, mask, iou_thres: float, max_det: int, agnostic: bool,
              use_soft_nms: bool, conf_thres: float):
    """Greedy or soft NMS of ranked candidates (bs, k, ...) and their kept
    rows [xyxy, conf, cls, mask...]: (out (bs, max_det, 6+nm), n_valid (bs,) int32)."""
    nms_box = box if agnostic else box + (cj * MAX_WH)[..., None]
    if use_soft_nms:
        keep, score_col = soft_nms_padded(nms_box, scores, iou_thres, max_det,
                                          score_threshold=conf_thres)
    else:
        keep = nms_padded(nms_box, scores, iou_thres, max_det)
    valid = keep >= 0
    safe = keep.clamp(min=0)
    if not use_soft_nms:
        score_col = scores.gather(1, safe)
    nm = mask.shape[-1]
    out = torch.cat([box.gather(1, safe[..., None].expand(-1, -1, 4)), score_col[..., None],
                     cj.gather(1, safe)[..., None],
                     mask.gather(1, safe[..., None].expand(-1, -1, nm))], -1)
    return torch.where(valid[..., None], out, 0.0), valid.sum(1).to(torch.int32)


def _ranked(x: torch.Tensor, k: int):
    """The k largest of each row, equal values in ascending index order (lax.top_k's)."""
    return (t[:, :k] for t in x.sort(dim=1, descending=True, stable=True))


def nms_batched(prediction: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                multi_label: bool = False, agnostic: bool = False, max_det: int = 300,
                nm: int = 0, pre_nms_topk: int = 4096,
                classes_mask: Optional[torch.Tensor] = None, use_soft_nms: bool = False):
    """NMS of decoded predictions (JAX ops/nms.py:255): prediction (bs, N,
    5+nc+nm) [xywh, obj, cls..., mask...]. conf = obj · cls; every column past
    the objectness, the mask coefficients too, is scaled by obj, as the
    reference does (utils/general.py:949). Multi-label: every (box, class)
    score above conf_thres competes; else one label a box, obj and conf both
    above conf_thres. The top pre_nms_topk scores go to the greedy NMS or, with
    use_soft_nms, the soft one (kept scores as selected). classes_mask:
    optional (nc,) bool. Returns (out (bs, max_det, 6+nm) rows [xyxy, conf,
    cls, mask...], n_valid (bs,) int32)."""
    bs, n, no = prediction.shape
    nc = no - nm - 5
    if nc < 1:
        raise ValueError(f"prediction has {no} columns but nm={nm} implies {nc} classes; "
                         "pass the model's nm")
    obj = prediction[..., 4]
    box = xywh2xyxy(prediction[..., :4])
    cls_conf = prediction[..., 5:5 + nc] * obj[..., None]
    mask = prediction[..., 5 + nc:] * obj[..., None]
    if classes_mask is not None:
        cls_conf = torch.where(classes_mask, cls_conf, 0.0)
    k = min(pre_nms_topk, n * (nc if multi_label else 1))
    if multi_label and nc > 1:
        scores, idx = _ranked(torch.where(cls_conf > conf_thres, cls_conf, 0.0).reshape(bs, -1), k)
        bi, cj = idx // nc, (idx % nc).float()
    else:
        conf, cj_all = cls_conf.max(-1)
        conf = torch.where((conf > conf_thres) & (obj > conf_thres), conf, 0.0)
        scores, bi = _ranked(conf, k)
        cj = cj_all.gather(1, bi).float()
    scores = torch.where(scores > conf_thres, scores, 0.0)
    return _nms_rows(box.gather(1, bi[..., None].expand(-1, -1, 4)), scores, cj,
                     mask.gather(1, bi[..., None].expand(-1, -1, nm)), iou_thres, max_det,
                     agnostic, use_soft_nms, conf_thres)


def non_max_suppression(prediction, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        classes: Optional[Sequence[int]] = None, agnostic: bool = False,
                        multi_label: bool = False, labels=(), max_det: int = 300, nm: int = 0,
                        use_soft_nms: bool = False):
    """The reference's call (utils/general.py:886; JAX ops/nms.py:463) over
    `nms_batched`: decoded predictions (or a tuple whose first item they are)
    -> a list of (n, 6+nm) tensors, rows [x1, y1, x2, y2, conf, cls, mask...]."""
    if isinstance(prediction, (list, tuple)):
        prediction = prediction[0]
    nc = prediction.shape[2] - nm - 5
    classes_mask = None
    if classes is not None:
        classes_mask = torch.zeros(nc, dtype=torch.bool, device=prediction.device)
        classes_mask[torch.as_tensor(classes, dtype=torch.long)] = True
    out, n_valid = nms_batched(prediction, conf_thres, iou_thres, multi_label and nc > 1,
                               agnostic, max_det, nm, classes_mask=classes_mask,
                               use_soft_nms=use_soft_nms)
    return [out[i, :int(n)] for i, n in enumerate(n_valid.tolist())]


def nms_from_raw(raw: Sequence[torch.Tensor], anchors, strides, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, multi_label: bool = False, agnostic: bool = False,
                 max_det: int = 300, nm: int = 0, pre_nms_topk: int = 1024,
                 classes_mask: Optional[torch.Tensor] = None, use_soft_nms: bool = False):
    """Fused decode + NMS straight off the raw head maps (JAX nms_from_raw).

    Serving branch (multi_label=False or one class): confidences are reduced
    per level off the raw logits, one label per box. Multi-label branch (the
    validator's): every (candidate, class) score sigmoid(obj) * sigmoid(cls)
    in float32 above conf_thres competes. Either way the top `pre_nms_topk`
    scores are taken, and only those rows are gathered and decoded. The mask
    coefficients are scaled by the objectness, as the reference NMS does
    (utils/general.py:949). use_soft_nms: the Gaussian soft-NMS
    (`soft_nms_padded`, stopping at conf_thres) in place of the greedy one,
    each kept row with its score as selected.

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
    # lax.top_k's order: torch.topk fixes none among equal scores, which saturated
    # logits (1.0) and the zeros below conf_thres make common
    scores, idx = _ranked(conf, min(pre_nms_topk, conf.shape[1]))
    k = scores.shape[1]
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
    return _nms_rows(box, scores, cj, mask, iou_thres, max_det, agnostic, use_soft_nms,
                     conf_thres)
