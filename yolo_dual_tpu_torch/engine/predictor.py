"""Streaming prediction engine (port of yolo_dual_tpu/engine/predictor.py;
reference segment/predict.py:53-223).

Per frame: the CUDA letterbox kernel (kernels/preprocess.py), the conv+BN-folded
forward, fused decode + NMS off the raw head maps (ops/nms.py:nms_from_raw; with
`augment` the test-time-augmented forward and nms_batched) and
the proto mask decode (ops/mask_ops.py:process_mask), with the reference's
per-stage speed report. cv2 is imported only to decode image files and videos,
to read streams and to draw, show and save results; in-memory and `.npy`
frames need none of it, and crops and feature maps are saved as `.npy`
without cv2 and matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_dual_tpu_torch.data.augment import letterbox
from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.data.streams import (LoadScreenshots, LoadStreams, is_screenshot_source,
                                              is_stream_source)
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.ops.boxes import scale_boxes
from yolo_dual_tpu_torch.ops.mask_ops import process_mask, scale_image
from yolo_dual_tpu_torch.models.model import forward_augment
from yolo_dual_tpu_torch.ops.nms import nms_batched, nms_from_raw
from yolo_dual_tpu_torch.utils.general import LOGGER, Profile, increment_path, select_device
from yolo_dual_tpu_torch.utils.plots import Annotator, colors, feature_visualization, save_one_box

IMG_EXTS = (".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp")
VID_EXTS = (".avi", ".mkv", ".mov", ".mp4", ".mpeg", ".mpg", ".webm")


def _cv2(why: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{why} needs OpenCV (cv2), which is not installed; pass frames "
                          "in memory and save_img=False to predict without it") from e
    return cv2


def _counted(items, max_frames: Optional[int]):
    """The first `max_frames` of `items` (all of them when None)."""
    for n, item in enumerate(items, 1):
        yield item
        if max_frames is not None and n >= max_frames:
            return


def _video_frames(f: Path, vid_stride: int):
    """(path, RGB frame, fps) of every `vid_stride`-th frame of a video."""
    cv2 = _cv2("reading videos")
    cap = cv2.VideoCapture(str(f))
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if n % vid_stride == 0:
                yield str(f), np.ascontiguousarray(frame[..., ::-1]), fps
            n += 1
    finally:
        cap.release()


def iter_source(source, vid_stride: int = 1, max_frames: Optional[int] = None
                ) -> Iterator[Tuple[str, np.ndarray, Optional[float]]]:
    """Yield (name, RGB uint8 HWC frame, fps or None) (JAX
    engine/predictor.py:29, which yields BGR frames). fps is set for video
    and stream frames, None for stills.

    `source` is an image file, a video (VID_EXTS, cv2.VideoCapture, every
    `vid_stride`-th frame), an RGB uint8 `.npy` frame, or a directory of
    them (images and videos need cv2, `.npy` frames only numpy); a stream
    (webcam index, rtsp/rtmp/http/tcp URL, a `.streams` list file; cv2) or
    a screenshot ("screen [n [left top width height]]"; mss), bounded by
    `max_frames`, which counts yielded frames (a stream's: rounds over its
    sources); or an iterable of in-memory RGB uint8 HWC frames (numpy arrays
    or tensors), named frame0.jpg, frame1.jpg, ...
    """
    if not isinstance(source, (str, Path)):
        for i, im in _counted(enumerate(source), max_frames):
            yield f"frame{i}.jpg", im, None
        return
    if is_stream_source(source):
        streams = LoadStreams(source, vid_stride=vid_stride)
        try:
            for paths, frames in _counted(streams, max_frames):
                for si, (p, im) in enumerate(zip(paths, frames)):
                    yield str(p), np.ascontiguousarray(im[..., ::-1]), float(streams.fps[si])
        finally:
            streams.close()
        return
    if is_screenshot_source(source):
        for paths, frames in _counted(LoadScreenshots(source), max_frames):
            yield paths[0], np.ascontiguousarray(frames[0][..., ::-1]), None
        return
    src = Path(source)
    if src.is_dir():
        files = sorted(p for p in src.rglob("*.*")
                       if p.suffix.lower() in IMG_EXTS + VID_EXTS + (".npy",))
    elif src.is_file():
        files = [src]
    else:
        raise FileNotFoundError(f"source {source} not found")
    for f in files:
        if f.suffix.lower() in VID_EXTS:   # max_frames counts a video's yielded frames
            yield from _counted(_video_frames(f, vid_stride), max_frames)
            continue
        if f.suffix.lower() == ".npy":
            yield str(f.with_suffix(".jpg")), np.load(f), None
            continue
        im = _cv2("reading image files").imread(str(f))
        if im is None:
            LOGGER.warning(f"could not read {f}")
            continue
        yield str(f), np.ascontiguousarray(im[..., ::-1]), None


def source_stem(path) -> str:
    """Filesystem-safe stem for an output named after a source: the file
    stem for paths, the sanitised URL for stream sources."""
    p = Path(path)
    return p.stem if p.suffix else str(path).replace("://", "_").replace("/", "_")


def save_media_frame(save_dir, path, frame_bgr: np.ndarray, fps: Optional[float],
                     vid_writers: dict) -> None:
    """Write one output frame (JAX engine/predictor.py:120): a still to
    <save_dir>/<name>; a video or stream frame to one mp4 a source, its
    cv2.VideoWriter made at the first frame and kept in `vid_writers` by
    source path, which the caller releases when the source loop ends."""
    cv2 = _cv2("saving annotated frames")
    if fps is not None:
        if path not in vid_writers:
            outp = Path(save_dir) / f"{source_stem(path)}.mp4"
            h, w = frame_bgr.shape[:2]
            vid_writers[path] = cv2.VideoWriter(
                str(outp), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        vid_writers[path].write(np.ascontiguousarray(frame_bgr))
    else:
        cv2.imwrite(str(Path(save_dir) / Path(path).name), frame_bgr)


def _annotate(save_dir: Path, path: str, im0, dets: torch.Tensor, masks: torch.Tensor,
              imgsz: int, names, line_thickness: int, hide_labels: bool, hide_conf: bool,
              save_img: bool, save_txt: bool, save_conf: bool, save_crop: bool, view_img: bool,
              fps: Optional[float], frame: int, vid_writers: dict):
    """Draw / write one frame's results at its native resolution."""
    im0 = np.asarray(im0.cpu() if isinstance(im0, torch.Tensor) else im0)
    h0, w0 = im0.shape[:2]
    boxes_native = scale_boxes((imgsz, imgsz), dets[:, :4], (h0, w0)).cpu().numpy()
    confs, clss = dets[:, 4].cpu().numpy(), dets[:, 5].cpu().numpy()
    if save_img or view_img:
        cv2 = _cv2("saving or showing annotated frames")
        annotator = Annotator(im0.copy(), line_width=line_thickness)
        if len(dets):
            masks_native = scale_image((imgsz, imgsz), masks.float(), (h0, w0)) > 0.5
            annotator.masks(masks_native.cpu().numpy(), [colors(int(c)) for c in clss])
        for box, conf, cls in zip(boxes_native, confs, clss):
            label = None if hide_labels else (
                names[int(cls)] if hide_conf else f"{names[int(cls)]} {conf:.2f}")
            annotator.box_label(box, label or "", color=colors(int(cls)))
        if save_img:
            save_media_frame(save_dir, path, annotator.result()[..., ::-1], fps, vid_writers)
        if view_img:
            cv2.imshow(str(path), annotator.result()[..., ::-1])
            cv2.waitKey(1)
    if save_crop:
        # a crop a detection under crops/<class>/ (reference --save-crop)
        for box, cls in zip(boxes_native, clss):
            save_one_box(box, im0, file=save_dir / "crops" / names[int(cls)]
                         / f"{Path(path).stem}.jpg", BGR=False)
    if save_txt and len(dets):
        # normalized xywh rows, conf only with save_conf (reference predict.py:160-165);
        # a video or stream frame's rows go to <stem>_<frame>.txt
        suffix = f"_{frame}" if fps is not None else ""
        txt = save_dir / "labels" / f"{source_stem(path)}{suffix}.txt"
        txt.parent.mkdir(parents=True, exist_ok=True)
        with open(txt, "a") as f:
            for (x1, y1, x2, y2), conf, cls in zip(boxes_native, confs, clss):
                row = [int(cls), (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                       (x2 - x1) / w0, (y2 - y1) / h0]
                if save_conf:
                    row.append(float(conf))
                f.write(" ".join(f"{v:g}" for v in row) + "\n")


def visualize_features(model, image: torch.Tensor, save_dir) -> list:
    """Feature maps of every layer of `model` on `image` (JAX
    engine/predictor.py:182-197): a forward hook on each `model.model[i]`
    collects its output, and each 4-D one (JAX's `model_i` intermediate, NCHW
    here) goes through feature_visualization under save_dir/features.
    Returns the files written."""
    outs = {}
    hooks = [m.register_forward_hook(lambda mod, inp, out, i=i: outs.setdefault(i, out))
             for i, m in enumerate(model.model)]
    try:
        with torch.inference_mode():
            model(image)
    finally:
        for hk in hooks:
            hk.remove()
    files = []
    for i in sorted(outs):
        if isinstance(outs[i], torch.Tensor):
            f = feature_visualization(outs[i], f"model_{i}", i,
                                      save_dir=Path(save_dir) / "features")
            if f is not None:
                files.append(f)
    return files


def predict_images(model, source, imgsz: int = 640, conf_thres: float = 0.25,
                   iou_thres: float = 0.45, max_det: int = 300, nm: int = 32,
                   classes: Optional[Sequence[int]] = None, agnostic_nms: bool = False,
                   retina_masks: bool = False, save_dir: str = "runs/predict-seg/exp",
                   save_txt: bool = False, save_img: bool = True, names=None,
                   line_thickness: int = 3, hide_labels: bool = False, hide_conf: bool = False,
                   use_soft_nms: bool = False, augment: bool = False, vid_stride: int = 1,
                   max_frames: Optional[int] = None, view_img: bool = False, fuse: bool = True,
                   save_crop: bool = False, save_conf: bool = False, exist_ok: bool = False,
                   visualize: bool = False, device_preprocess: Optional[bool] = None,
                   device="cuda"):
    """Run streaming prediction. Returns the list of per-frame detection
    arrays (n, 6+nm) rows [x1, y1, x2, y2, conf, cls, mask coefs...] in
    letterboxed `imgsz` pixels, as the JAX function does.

    model: a SegmentationModel; it is moved to `device`, put in eval mode and,
    with fuse=True, conv+BN-folded in place. source: see iter_source
    (vid_stride, max_frames). augment: the test-time augmentation of
    models/model.py:forward_augment, its decoded predictions through
    nms_batched (JAX engine/predictor.py:160-175); use_soft_nms: Gaussian
    soft-NMS in place of the greedy one. Outputs under `save_dir`: the
    annotated frames (save_img; a video's or stream's as one mp4 a source),
    txt rows (save_txt, a video frame's in <stem>_<frame>.txt), crops
    (save_crop, crops/<class>/<stem>.jpg, `.npy` without cv2) and the first
    frame's feature maps (visualize, features/stage<i>_model_<i>.png, `.npy`
    without matplotlib); view_img shows each annotated frame (cv2.imshow).
    retina_masks is accepted and changes nothing: masks are always
    upsampled to the input and un-letterboxed to the frame (JAX
    engine/predictor.py:141-145). device_preprocess None or True letterboxes
    each frame on `device` (the letterbox kernel on the card, its plain
    version on the CPU), where JAX's None takes its device route on its
    accelerator; False letterboxes on the host (data/augment.py:letterbox),
    as JAX's host route (engine/predictor.py:195-197). The call's (pre,
    infer, post) Profile timers, whose totals the final speed line reports, stay readable
    afterwards as `predict_images.profiles`.
    """
    dev = select_device(device)
    if save_img or view_img:
        _cv2("saving or showing annotated frames")
    save_dir = increment_path(Path(save_dir), exist_ok=exist_ok,
                              mkdir=save_img or save_txt or save_crop or visualize)
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
    vid_writers = {}   # source path -> cv2.VideoWriter
    frame_idx = {}     # source path -> its frame number, for video and stream sources
    features_due = visualize
    dt = predict_images.profiles = tuple(Profile(device=dev) for _ in range(3))
    try:
        for path, im0, fps in iter_source(source, vid_stride=vid_stride, max_frames=max_frames):
            frame = frame_idx[path] = frame_idx.get(path, 0) + 1 if fps is not None else 0
            with dt[0]:
                if device_preprocess is None or device_preprocess:
                    batch = letterbox_normalize(torch.as_tensor(im0).to(dev)[None].contiguous(),
                                                imgsz)
                else:
                    batch = torch.as_tensor(letterbox(im0, imgsz)[0]).to(dev)[None]
                    batch = batch.permute(0, 3, 1, 2).contiguous()  # uint8 NCHW
            with dt[1]:
                out, n_valid, protos = forward(batch)
            if features_due:   # the first frame's feature maps
                features_due = False
                visualize_features(model, normalize_image(batch), save_dir)
            with dt[2], torch.inference_mode():
                n = int(n_valid[0])
                dets = out[0, :n]
                masks = None
                if n:
                    masks = process_mask(protos[0], dets[:, 6:6 + nm], dets[:, :4],
                                         (imgsz, imgsz), upsample=True)
                if save_img or save_txt or save_crop or view_img:
                    _annotate(save_dir, path, im0, dets, masks, imgsz, names, line_thickness,
                              hide_labels, hide_conf, save_img, save_txt, save_conf, save_crop,
                              view_img, fps, frame, vid_writers)
                results.append(dets.cpu().numpy())
            LOGGER.info(f"{path}: {n} detections ({dt[0].dt * 1e3:.1f}ms pre, "
                        f"{dt[1].dt * 1e3:.1f}ms infer, {dt[2].dt * 1e3:.1f}ms post)")
    finally:
        for wtr in vid_writers.values():
            wtr.release()
    n_img = max(len(results), 1)
    saved = save_img or save_txt or save_crop or visualize
    LOGGER.info(f"Speed: {dt[0].t / n_img * 1e3:.1f}ms pre, "
                f"{dt[1].t / n_img * 1e3:.1f}ms inference, "
                f"{dt[2].t / n_img * 1e3:.1f}ms post per image"
                + (f"; results saved to {save_dir}" if saved else ""))
    return results


predict_images.profiles = ()