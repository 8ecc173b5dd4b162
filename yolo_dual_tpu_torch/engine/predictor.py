"""Streaming prediction engine (port of yolo_dual_tpu/engine/predictor.py;
reference segment/predict.py:53-223).

Per frame: the CUDA letterbox kernel (kernels/preprocess.py), the conv+BN-folded
forward, fused decode + NMS off the raw head maps (ops/nms.py:nms_from_raw; with
`augment` the test-time-augmented forward and nms_batched) and
the proto mask decode (ops/mask_ops.py:process_mask), with the reference's
per-stage speed report. cv2 is imported only to decode image files and to draw
and save results; in-memory frames need neither.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.ops.boxes import scale_boxes
from yolo_dual_tpu_torch.ops.mask_ops import process_mask, scale_image
from yolo_dual_tpu_torch.models.model import forward_augment
from yolo_dual_tpu_torch.ops.nms import nms_batched, nms_from_raw
from yolo_dual_tpu_torch.utils.general import LOGGER, Profile, increment_path, select_device

IMG_EXTS = (".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp")


def _cv2(why: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{why} needs OpenCV (cv2), which is not installed; pass frames "
                          "in memory and save_img=False to predict without it") from e
    return cv2


def iter_source(source) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, RGB uint8 HWC frame).

    `source` is an image file or a directory of them: images are decoded with
    cv2; `.npy` files hold RGB uint8 HWC arrays and need only numpy. Or it is
    an iterable of in-memory RGB uint8 HWC frames (numpy arrays or tensors),
    named frame0.jpg, frame1.jpg, ...
    """
    if not isinstance(source, (str, Path)):
        for i, im in enumerate(source):
            yield f"frame{i}.jpg", im
        return
    src = Path(source)
    if src.is_dir():
        files = sorted(p for p in src.rglob("*.*") if p.suffix.lower() in IMG_EXTS + (".npy",))
    elif src.is_file():
        files = [src]
    else:
        raise FileNotFoundError(f"source {source} not found")
    for f in files:
        if f.suffix.lower() == ".npy":
            yield str(f.with_suffix(".jpg")), np.load(f)
            continue
        im = _cv2("reading image files").imread(str(f))
        if im is None:
            LOGGER.warning(f"could not read {f}")
            continue
        yield str(f), np.ascontiguousarray(im[..., ::-1])


def _annotate(save_dir: Path, path: str, im0, dets: torch.Tensor, masks: torch.Tensor,
              imgsz: int, names, line_thickness: int, hide_labels: bool, hide_conf: bool,
              save_img: bool, save_txt: bool, save_conf: bool):
    """Draw / write one frame's results at its native resolution."""
    from yolo_dual_tpu_torch.utils.plots import Annotator, colors
    im0 = np.asarray(im0.cpu() if isinstance(im0, torch.Tensor) else im0)
    h0, w0 = im0.shape[:2]
    boxes_native = scale_boxes((imgsz, imgsz), dets[:, :4], (h0, w0)).cpu().numpy()
    confs, clss = dets[:, 4].cpu().numpy(), dets[:, 5].cpu().numpy()
    if save_img:
        cv2 = _cv2("saving annotated images")
        annotator = Annotator(im0.copy(), line_width=line_thickness)
        if len(dets):
            masks_native = scale_image((imgsz, imgsz), masks.float(), (h0, w0)) > 0.5
            annotator.masks(masks_native.cpu().numpy(), [colors(int(c)) for c in clss])
        for box, conf, cls in zip(boxes_native, confs, clss):
            label = None if hide_labels else (
                names[int(cls)] if hide_conf else f"{names[int(cls)]} {conf:.2f}")
            annotator.box_label(box, label or "", color=colors(int(cls)))
        cv2.imwrite(str(save_dir / Path(path).name), annotator.result()[..., ::-1])
    if save_txt and len(dets):
        # normalized xywh rows, conf only with save_conf (reference predict.py:160-165)
        txt = save_dir / "labels" / f"{Path(path).stem}.txt"
        txt.parent.mkdir(parents=True, exist_ok=True)
        with open(txt, "a") as f:
            for (x1, y1, x2, y2), conf, cls in zip(boxes_native, confs, clss):
                row = [int(cls), (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                       (x2 - x1) / w0, (y2 - y1) / h0]
                if save_conf:
                    row.append(float(conf))
                f.write(" ".join(f"{v:g}" for v in row) + "\n")


def predict_images(model, source, imgsz: int = 640, conf_thres: float = 0.25,
                   iou_thres: float = 0.45, max_det: int = 300, nm: int = 32,
                   classes: Optional[Sequence[int]] = None, agnostic_nms: bool = False,
                   save_dir: str = "runs/predict-seg/exp", save_txt: bool = False,
                   save_img: bool = True, names=None, line_thickness: int = 3,
                   hide_labels: bool = False, hide_conf: bool = False, fuse: bool = True,
                   save_conf: bool = False, exist_ok: bool = False, device="cuda",
                   use_soft_nms: bool = False, augment: bool = False):
    """Run streaming prediction. Returns the list of per-frame detection
    arrays (n, 6+nm) rows [x1, y1, x2, y2, conf, cls, mask coefs...] in
    letterboxed `imgsz` pixels, as the JAX function does.

    model: a SegmentationModel; it is moved to `device`, put in eval mode and,
    with fuse=True, conv+BN-folded in place. augment: the test-time
    augmentation of models/model.py:forward_augment, its decoded predictions
    through nms_batched (JAX engine/predictor.py:160-175); use_soft_nms:
    Gaussian soft-NMS in place of the greedy one. The call's (pre, infer, post)
    Profile timers, whose totals the final speed line reports, stay readable
    afterwards as `predict_images.profiles`.
    """
    dev = select_device(device)
    if save_img:
        _cv2("saving annotated images")
    save_dir = increment_path(Path(save_dir), exist_ok=exist_ok,
                              mkdir=save_img or save_txt)
    model = model.to(dev).eval()
    if fuse:
        model.fuse()
    names = names or {i: str(i) for i in range(model.nc)}
    head = model.model[-1]
    anchors, strides = head.anchors, head.strides
    classes_mask = None
    if classes is not None:
        classes_mask = torch.zeros(model.nc, dtype=torch.bool, device=dev)
        classes_mask[torch.as_tensor(classes, dtype=torch.long)] = True

    kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, agnostic=agnostic_nms, max_det=max_det,
              nm=nm, classes_mask=classes_mask, use_soft_nms=use_soft_nms)

    @torch.inference_mode()
    def forward(image):
        if augment:
            pred, protos = forward_augment(model, normalize_image(image))
            out, n_valid = nms_batched(pred, **kw)
        else:
            levels, protos = model(normalize_image(image), decode=False)
            out, n_valid = nms_from_raw(levels, anchors, strides, **kw)
        return out, n_valid, protos

    results = []
    dt = predict_images.profiles = tuple(Profile(device=dev) for _ in range(3))
    for path, im0 in iter_source(source):
        with dt[0]:
            frame = torch.as_tensor(im0).to(dev)[None].contiguous()
            batch = letterbox_normalize(frame, imgsz)
        with dt[1]:
            out, n_valid, protos = forward(batch)
        with dt[2], torch.inference_mode():
            n = int(n_valid[0])
            dets = out[0, :n]
            masks = None
            if n:
                masks = process_mask(protos[0], dets[:, 6:6 + nm], dets[:, :4], (imgsz, imgsz),
                                     upsample=True)
            if save_img or save_txt:
                _annotate(save_dir, path, im0, dets, masks, imgsz, names, line_thickness,
                          hide_labels, hide_conf, save_img, save_txt, save_conf)
            results.append(dets.cpu().numpy())
        LOGGER.info(f"{path}: {n} detections "
                    f"({dt[0].dt * 1e3:.1f}ms pre, {dt[1].dt * 1e3:.1f}ms infer, {dt[2].dt * 1e3:.1f}ms post)")
    n_img = max(len(results), 1)
    LOGGER.info(f"Speed: {dt[0].t / n_img * 1e3:.1f}ms pre, {dt[1].t / n_img * 1e3:.1f}ms inference, "
                f"{dt[2].t / n_img * 1e3:.1f}ms post per image"
                + (f"; results saved to {save_dir}" if save_img or save_txt else ""))
    return results


predict_images.profiles = ()