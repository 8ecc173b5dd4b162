"""Instance-segmentation evaluation, box + mask mAP, and semantic evaluation,
confusion-matrix mIoU (port of yolo_dual_tpu/engine/validator.py:
evaluate_segment, evaluate_semantic; reference segment/val.py:128-400,
unet-lite/Resnet50/val_diceloss.py:148-293).

Per batch on the device: the letterbox kernel on raw frames
(kernels/preprocess.py, `image_raw` batches), the forward, the multi-label
decode + NMS off the raw head maps (ops/nms.py; with `augment` the
test-time-augmented forward and the NMS of its decoded predictions; greedy
or, with `use_soft_nms`, Gaussian soft-NMS), and the whole TP matching,
batched over images: box IoU against the gt, the proto masks, mask IoU, and
`match_predictions_device` for both. The host only slices the padded results
and runs the AP curves (metrics/).

With `mesh` (parallel/mesh.py, one process a rank) each rank evaluates its
rows of every global batch (data/loader.py:Loader's shards, or
parallel/mesh.py:shard_batch), and the ranks' statistics are gathered in
global-batch order (segment: each image's matches; semantic: the
confusion matrices summed, the val loss taken over the global batch), so the
metrics equal the one-process run's, as JAX's mesh evaluation does
(tests/test_eval_dp.py). Every rank returns them; the times are the rank's
own per image. On a 2-D mesh (parallel/mesh.py:make_mesh_2d; JAX
engine/validator.py:49-52, 272-305) each rank runs the forward on its band of
its data shard's images (parallel/spatial.py), the outputs come back whole on
every space rank, and the ranks with space index 0 alone feed the metrics.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize, semantic_preprocess
from yolo_dual_tpu_torch.metrics import (Metrics, SegmentationConfusionMatrix,
                                         ap_per_class_box_and_mask, match_predictions_device)
from yolo_dual_tpu_torch.ops.boxes import box_iou, clip_boxes, scale_boxes, xywh2xyxy
from yolo_dual_tpu_torch.ops.mask_ops import (mask_iou, process_mask, resize_linear_f32,
                                              scale_image)
from yolo_dual_tpu_torch.models.model import forward_augment
from yolo_dual_tpu_torch.ops.nms import nms_batched, nms_from_raw
from yolo_dual_tpu_torch.parallel import spatial
from yolo_dual_tpu_torch.parallel.mesh import (across, band_rows, gather_batches, global_sum,
                                               is_main)
from yolo_dual_tpu_torch.utils.coco import (evaluate_coco_json, save_one_json,
                                            write_predictions_json)
from yolo_dual_tpu_torch.utils.general import LOGGER, Profile, select_device

PRE_NMS_TOPK = 4096  # candidates (box, class) ranked before NMS, as the JAX validator


def batch_matches(out, n_valid, protos, targets, tmask, gmasks, h: int, w: int, nm: int):
    """TP matrices (bs, D, 10) of boxes and of masks for one batch of NMS
    output against its gt (JAX evaluate_segment's per_image, batched)."""
    bs, D = out.shape[:2]
    M = targets.shape[1]
    gain = torch.tensor([w, h, w, h], dtype=torch.float32, device=out.device)
    gt_boxes = xywh2xyxy(targets[..., 1:5] * gain)
    gt_cls = targets[..., 0]
    det_valid = torch.arange(D, device=out.device) < n_valid[:, None]
    pair_ok = tmask[:, :, None] & det_valid[:, None, :]                      # (bs, M, D)
    # the reference matches CLIPPED boxes (scale_boxes -> clip_boxes, segment/val.py:300)
    iou_b = torch.where(pair_ok, box_iou(gt_boxes, clip_boxes(out[..., :4], (h, w))), 0.0)
    correct_b = match_predictions_device(out[..., 5], gt_cls, iou_b)
    mh, mw = gmasks.shape[-2:]
    if gmasks.ndim == 4:        # non-overlap: (bs, M, mh, mw) instance masks
        gt_m = gmasks.float()
    else:                       # overlap-encoded plane (bs, mh, mw)
        gt_m = (gmasks[:, None] == torch.arange(1, M + 1, device=out.device)[:, None, None]
                ).float()
    pm = torch.stack([process_mask(protos[i], out[i, :, 6:6 + nm], out[i, :, :4], (h, w),
                                   upsample=False, binarize=False) for i in range(bs)])
    pm = (pm > 0.5).float()
    if pm.shape[-2:] != (mh, mw):
        pm = F.interpolate(pm, size=(mh, mw), mode="nearest-exact")
    iou_m = mask_iou(gt_m.reshape(bs, M, -1), pm.reshape(bs, D, -1))
    correct_m = match_predictions_device(out[..., 5], gt_cls, torch.where(pair_ok, iou_m, 0.0))
    return correct_b, correct_m


def _txt_rows(boxes: torch.Tensor, cls, conf, shape_hw, shape0, save_conf: bool):
    """Label rows `cls x y w h [conf]`, boxes in the letterboxed frame
    rescaled to the original image, normalised (reference save_one_txt)."""
    h0, w0 = shape0
    b = scale_boxes(shape_hw, boxes, shape0).numpy()
    xywhn = np.stack([(b[:, 0] + b[:, 2]) / 2 / w0, (b[:, 1] + b[:, 3]) / 2 / h0,
                      (b[:, 2] - b[:, 0]) / w0, (b[:, 3] - b[:, 1]) / h0], 1)
    lines = []
    for k in range(len(b)):
        row = [int(cls[k]), *xywhn[k]]
        if save_conf:
            row.append(float(conf[k]))
        lines.append(" ".join(f"{v:g}" for v in row))
    return lines


def _band(image: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's band of rows of an NCHW batch on a 2-D mesh, else the batch."""
    if mesh is None or mesh.sp == 1:
        return image
    return image[:, :, band_rows(image.shape[2], mesh)]


def evaluate_segment(model, loader, nc: int, conf_thres: float = 0.001, iou_thres: float = 0.6,
                     max_det: int = 300, nm: int = 32, names=None, plots: bool = False,
                     save_dir: str = ".", use_soft_nms: bool = False, augment: bool = False,
                     save_json: bool = False, anno_json=None, class_map=None, fuse: bool = True,
                     save_txt: bool = False, save_conf: bool = False, save_hybrid: bool = False,
                     mesh=None, device="cuda", amp_dtype=None, verbose: bool = False,
                     mask_ratio: int = 4, compute_loss=None):
    """Returns ((mp, mr, map50, map) of boxes + the same of masks, per-class
    maps (boxes' plus masks'), times_ms (pre, inference+NMS, post per image)).
    mask_ratio and compute_loss are accepted and not read, as in JAX (the
    masks' ratio is the loader's planes').

    model: a SegmentationModel; it is moved to `device`, put in eval mode and,
    with fuse=True, conv+BN-folded in place. loader: any iterable of batches in
    the JAX loader's format: `image` uint8 (bs, h, w, 3) letterboxed frames,
    or `image_raw` uint8 raw frames, which the letterbox kernel fits to
    `loader.dataset.imgsz` on the card (scaleup=False, fill 114); `targets`
    (bs, M, 5) [cls, xywh normalised], `tmask` (bs, M), `masks` overlap planes
    (bs, mh, mw) or instance masks (bs, M, mh, mw), optional `n_valid`; with
    save_txt also `index` and `shape0`, and `loader.dataset.im_files`.
    amp_dtype (torch.bfloat16): the forward runs under torch.autocast, as the
    train CLI's --dtype bf16 model; its outputs are converted to float32.
    augment: the test-time augmentation of models/model.py:forward_augment,
    whose decoded predictions go through nms_batched, its masks from the
    identity pass' protos (JAX engine/validator.py:67-79); on a space mesh
    it runs gathered, the whole frames on every space rank, as
    models/model.py:_walk runs a gathered layer. use_soft_nms:
    Gaussian soft-NMS in place of the greedy one. Batches may differ in
    (h, w) (rect buckets, data/dataset.py): the head's grids, the NMS and the
    masks follow each batch's shape. verbose: a row of the 8 metrics for each
    class with labels (reference segment/val.py; JAX's evaluate_segment
    takes the flag and prints none). save_json: each kept detection of a
    frame with `index` and `shape0` (and `loader.dataset.im_files`) in COCO's
    results format, its category through `class_map`, its mask as compressed
    RLE at the frame's own size, into `save_dir`/predictions.json (JAX
    engine/validator.py:213-240): the proto masks binarised, resized to the
    input with cv2's float32 INTER_LINEAR and un-letterboxed the same way
    (ops/mask_ops.py:resize_linear_f32, scale_image, on the device),
    then > 0.5; with `anno_json`, COCOeval where pycocotools is installed.
    """
    dev = select_device(device)
    model = model.to(dev).eval()
    if fuse:
        model.fuse()
    head = model.model[-1]
    anchors, strides = head.anchors, head.strides
    im_files = getattr(getattr(loader, "dataset", None), "im_files", None)

    per_batch = []  # a list a batch of its images' (tp boxes, tp masks, conf, class, gt classes)
    jdict = []
    dt = [Profile(device=dev), Profile(device=dev), Profile(device=dev)]
    seen = 0
    for batch in loader:
        with dt[0]:
            if "image_raw" in batch:
                raw = torch.as_tensor(batch["image_raw"]).to(dev).contiguous()
                image = letterbox_normalize(raw, loader.dataset.imgsz, scaleup=False)
            else:
                image = normalize_image(torch.as_tensor(batch["image"]).to(dev)
                                        .permute(0, 3, 1, 2)).contiguous()
            targets, tmask, gmasks = (torch.as_tensor(batch[k]).to(dev)
                                      for k in ("targets", "tmask", "masks"))
        h, w = image.shape[2:]
        with dt[1], torch.inference_mode():
            with torch.autocast(dev.type, dtype=amp_dtype or torch.float32,
                                enabled=amp_dtype is not None), spatial.spatial(mesh):
                if augment:  # gathered: the whole frames on every space rank, whose scales
                    with spatial.whole_maps():  # give heights the bands need not divide
                        pred, protos = forward_augment(model, image)
                else:
                    levels, protos = model(_band(image, mesh), decode=False)
            if augment:
                out, n_valid = nms_batched(pred.float(), conf_thres=conf_thres,
                                           iou_thres=iou_thres, multi_label=True,
                                           max_det=max_det, nm=nm, pre_nms_topk=PRE_NMS_TOPK,
                                           use_soft_nms=use_soft_nms)
            else:
                out, n_valid = nms_from_raw([lv.float() for lv in levels], anchors, strides,
                                            conf_thres=conf_thres, iou_thres=iou_thres,
                                            multi_label=True, max_det=max_det, nm=nm,
                                            pre_nms_topk=PRE_NMS_TOPK, use_soft_nms=use_soft_nms)
            protos = protos.float()
            cb, cm = batch_matches(out, n_valid, protos, targets, tmask.bool(), gmasks, h, w, nm)
        bsz = int(batch.get("n_valid", image.shape[0]))
        stats = []
        per_batch.append(stats)
        with dt[2]:
            out_h, nv, cb, cm = out.cpu(), n_valid.cpu().numpy(), cb.cpu().numpy(), cm.cpu().numpy()
            for si in range(bsz):
                seen += 1
                n = int(nv[si])
                dets = out_h[si, :n]
                t = np.asarray(batch["targets"][si])
                tm = np.asarray(batch["tmask"][si]).astype(bool)
                stats.append((cb[si, :n], cm[si, :n], dets[:, 4].numpy(), dets[:, 5].numpy(),
                              t[tm][:, 0]))
                if save_txt and im_files is not None and "index" in batch and \
                        (mesh is None or mesh.space_rank == 0):
                    path = Path(im_files[int(batch["index"][si])])
                    shape0 = tuple(int(v) for v in batch["shape0"][si])
                    lines = _txt_rows(dets[:, :4], dets[:, 5], dets[:, 4], (h, w), shape0,
                                      save_conf) if n else []
                    if save_hybrid and tm.any():
                        # gt rows at conf 1.0 (the reference's autolabelling artifact)
                        g = xywh2xyxy(torch.from_numpy(t[tm][:, 1:5])
                                      * torch.tensor([w, h, w, h], dtype=torch.float32))
                        lines += _txt_rows(g, t[tm][:, 0], np.ones(len(g)), (h, w), shape0,
                                           save_conf)
                    lbl_dir = Path(save_dir) / "labels"
                    lbl_dir.mkdir(parents=True, exist_ok=True)
                    (lbl_dir / f"{path.stem}.txt").write_text(
                        "\n".join(lines) + ("\n" if lines else ""))
                if save_json and n and im_files is not None and "index" in batch:
                    shape0 = tuple(int(v) for v in batch["shape0"][si])
                    d = out[si, :n]
                    with torch.inference_mode():
                        pm = process_mask(protos[si], d[:, 6:6 + nm], d[:, :4], (h, w)).float()
                        pm = scale_image((h, w), resize_linear_f32(pm, h, w), shape0) > 0.5
                    save_one_json(jdict, im_files[int(batch["index"][si])],
                                  scale_boxes((h, w), dets[:, :4], shape0).numpy(),
                                  dets[:, 4].numpy(), dets[:, 5].numpy(), pred_masks=pm,
                                  class_map=class_map)

    stats = gather_batches(per_batch, mesh)
    if save_json:
        jdict = gather_batches([jdict], mesh)
    if save_json and jdict and is_main(mesh):
        pred_json = write_predictions_json(jdict, save_dir)
        if anno_json is not None:
            coco = evaluate_coco_json(pred_json, anno_json)
            if coco is not None:
                LOGGER.info(f"COCOeval: box mAP {coco[0]:.4f}/mAP50 {coco[1]:.4f}, "
                            f"mask mAP {coco[2]:.4f}/mAP50 {coco[3]:.4f}")

    if not stats:
        return (0.0,) * 8, np.zeros(nc), (0.0, 0.0, 0.0)
    tp_b, tp_m, conf, pred_cls, target_cls = (np.concatenate(x) for x in zip(*stats))
    metrics = Metrics()
    if tp_b.any() or len(conf):
        metrics.update(ap_per_class_box_and_mask(
            tp_b, tp_m, conf, pred_cls, target_cls, save_dir=save_dir,
            plot=plots and is_main(mesh),
            names=names or {i: str(i) for i in range(nc)}))
    mean = metrics.mean_results()
    t = tuple(x.t / max(seen, 1) * 1e3 for x in dt)
    LOGGER.info(("%22s" + "%11s" * 8) % ("Class", "P(B)", "R(B)", "mAP50(B)", "mAP50-95(B)",
                                         "P(M)", "R(M)", "mAP50(M)", "mAP50-95(M)"))
    LOGGER.info(("%22s" + "%11.3g" * 8) % ("all", *mean))
    if verbose and nc > 1:
        names = names or {i: str(i) for i in range(nc)}
        nt = np.bincount(target_cls.astype(int), minlength=nc)
        for i, c in enumerate(metrics.ap_class_index):
            LOGGER.info(("%22s" + "%11i" * 2 + "%11.3g" * 8)
                        % (names.get(int(c), str(c)), len(stats), nt[c], *metrics.class_result(i)))
    LOGGER.info(f"Speed: {t[0]:.1f}ms pre, {t[1]:.1f}ms inference+NMS, {t[2]:.1f}ms post per image")
    return mean, metrics.get_maps(nc), t


def evaluate_semantic(model, loader, nc: int, ignore_index: Optional[int] = 11, loss_fn=None,
                      verbose: bool = False, names=None, mesh=None, device="cuda"):
    """Semantic mIoU evaluation (JAX engine/validator.py:265). Returns
    ((miou, val_loss, 0, 0), per-class IoU, (ms per image,)).

    model: a SemanticSegModel; moved to `device`, put in eval mode and
    conv+BN-folded in place, so a caller that trains on hands over a copy
    (semantic.train does). loader: batches of `image` uint8
    (bs, s, s, 3) and `mask` (bs, s, s) from the host route, or `image_raw` /
    `mask_raw` at the frames' native size, which `semantic_preprocess` fits
    to `loader.dataset.img_size` on the device (on the card: K1, one launch
    a batch, timed with the forward as JAX times it); optional `n_valid`.
    The argmax runs on the device, the confusion matrix on the host;
    `loss_fn` (a SemanticSegLoss) gives the mean val loss over batches."""
    dev = select_device(device)
    model = model.to(dev).eval().fuse()
    cm = SegmentationConfusionMatrix(nc, ignore_index=ignore_index)
    total_loss, n_batches, seen = 0.0, 0, 0
    dt = Profile(device=dev)
    for batch in loader:
        if "image_raw" in batch:
            with dt:
                image, gt = semantic_preprocess(
                    torch.as_tensor(batch["image_raw"]).to(dev).contiguous(),
                    torch.as_tensor(batch["mask_raw"]).to(dev), out_size=loader.dataset.img_size)
        else:
            image = torch.as_tensor(batch["image"]).to(dev).permute(0, 3, 1, 2)
            gt = torch.as_tensor(batch["mask"]).to(dev)
        with dt, torch.inference_mode(), spatial.spatial(mesh):
            out = model(_band(normalize_image(image), mesh).contiguous())
        bsz = int(batch.get("n_valid", image.shape[0]))
        with torch.inference_mode(), across(mesh):
            cm.update(out[:bsz].argmax(1).cpu().numpy(), gt[:bsz].cpu().numpy())
            if loss_fn is not None:  # the global batch's loss under a mesh
                total_loss += float(global_sum(loss_fn(out[:bsz], gt[:bsz])[0]))
                n_batches += 1
        seen += bsz
    with across(mesh):
        cm.matrix = global_sum(torch.from_numpy(cm.matrix)).numpy()
    miou, iou = cm.compute_iou()
    avg_loss = total_loss / max(n_batches, 1)
    t = dt.t / max(seen, 1) * 1e3
    LOGGER.info(f"mIoU: {miou:.4f}  val-loss: {avg_loss:.4f}  ({t:.1f} ms/img)")
    if verbose and names:
        for i, v in enumerate(iou):
            tag = " (ignored)" if i == ignore_index else ""
            LOGGER.info(f"  {names.get(i, i):>12}: IoU {v:.4f}{tag}")
    return (miou, avg_loss, 0.0, 0.0), iou, (t,)
