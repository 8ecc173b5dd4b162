"""Hub-style inference API (port of yolo_dual_tpu/engine/autoshape.py;
reference models/common.py:627-835): `AutoShape` takes file paths, numpy
arrays or PIL images of any size and returns a `Detections` with rendering,
cropping and tabular export.

A call letterboxes every image on the host (the JAX AutoShape's `letterbox(...,
auto=False)`), runs one batched forward on the model's device with
decode=False, then the fused decode + NMS off the raw head maps
(ops/nms.py:nms_from_raw, serving branch), the Segment head's mask decode and
un-letterbox, and rescales the boxes to each image. cv2 is needed only to read
image files and to draw, save or crop; PIL only for PIL images; pandas only
for `Detections.pandas`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from yolo_dual_tpu_torch.data.augment import letterbox
from yolo_dual_tpu_torch.models.heads import Detect, DetectAux, Segment
from yolo_dual_tpu_torch.ops.boxes import scale_boxes
from yolo_dual_tpu_torch.ops.mask_ops import process_mask, scale_image
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.utils.general import LOGGER, Profile, increment_path


def _cv2(why: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{why} needs OpenCV (cv2), which is not installed; pass RGB "
                          "uint8 numpy arrays instead") from e
    return cv2


class Detections:
    """Per-image results (JAX engine/autoshape.py:19; reference
    models/common.py:726-835): `ims` the RGB uint8 images, `dets` (n, 6 + nm)
    float32 rows [x1, y1, x2, y2, conf, cls, mask coefficients...] in each
    image's pixels, `masks` (n, h, w) bool at image size or None, `t` the
    call's (letterbox, forward + NMS, rescale) ms an image."""

    def __init__(self, ims, dets, masks, names, times=(0.0, 0.0, 0.0)):
        self.ims = ims
        self.dets = dets
        self.masks = masks
        self.names = names
        self.t = times
        self.n = len(ims)

    def __len__(self):
        return self.n

    def to_dicts(self) -> List[List[dict]]:
        """One list of {xmin, ymin, xmax, ymax, confidence, class, name} an
        image (the reference's .pandas() rows without pandas)."""
        return [[{"xmin": float(d[0]), "ymin": float(d[1]), "xmax": float(d[2]),
                  "ymax": float(d[3]), "confidence": float(d[4]), "class": int(d[5]),
                  "name": self.names.get(int(d[5]), str(int(d[5])))} for d in det]
                for det in self.dets]

    def pandas(self):
        import pandas as pd
        return [pd.DataFrame(rows) for rows in self.to_dicts()]

    def render(self) -> List[np.ndarray]:
        """Each image with its masks blended in and its boxes labelled."""
        from yolo_dual_tpu_torch.utils.plots import Annotator, colors
        rendered = []
        for im, det, msk in zip(self.ims, self.dets, self.masks):
            ann = Annotator(im.copy())
            if msk is not None and len(msk):
                ann.masks(msk, [colors(int(c)) for c in det[:, 5]])
            for d in det:
                cls = int(d[5])
                ann.box_label(d[:4], f"{self.names.get(cls, cls)} {d[4]:.2f}", colors(cls))
            rendered.append(ann.result())
        return rendered

    def save(self, save_dir="runs/detect/exp") -> Path:
        cv2 = _cv2("saving rendered images")
        save_dir = increment_path(Path(save_dir), mkdir=True)
        for i, im in enumerate(self.render()):
            cv2.imwrite(str(save_dir / f"image{i}.jpg"), im[..., ::-1])
        LOGGER.info(f"saved {self.n} images to {save_dir}")
        return save_dir

    def crop(self, save_dir="runs/detect/exp") -> Path:
        """Each detection's box cut out of its image, under crops/{class name}/;
        a box narrower than a pixel keeps one (JAX's crop of it fails in
        cv2.imwrite)."""
        cv2 = _cv2("saving crops")
        save_dir = increment_path(Path(save_dir), mkdir=True)
        k = 0
        for im, det in zip(self.ims, self.dets):
            for d in det:
                x1, y1, x2, y2 = (int(v) for v in d[:4])
                x1, y1 = min(max(x1, 0), im.shape[1] - 1), min(max(y1, 0), im.shape[0] - 1)
                out = save_dir / "crops" / self.names.get(int(d[5]), str(int(d[5])))
                out.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(out / f"{k}.jpg"),
                            im[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)][..., ::-1])
                k += 1
        return save_dir

    def print(self):
        for i, det in enumerate(self.dets):
            LOGGER.info(f"image {i}: {len(det)} detections")


class AutoShape:
    """A Detect, Segment or DetectAux model behind input-robust preprocessing and NMS
    (JAX engine/autoshape.py:90; reference models/common.py:627-724). The
    model runs where it lies, in eval mode; with fuse=True its Conv+BN pairs
    are folded in place first, as the reference's hub loader does."""

    def __init__(self, model, imgsz: int = 640, conf: float = 0.25, iou: float = 0.45,
                 max_det: int = 300, names: Optional[dict] = None, fuse: bool = True):
        head = model.model[-1]
        if not isinstance(head, (Detect, DetectAux)):
            raise NotImplementedError(f"AutoShape needs a Detect, Segment or DetectAux head, "
                                      f"not {type(head).__name__}")
        self.model = model.eval()
        if fuse:
            model.fuse()
        self.device = next(model.parameters()).device
        self.imgsz, self.conf, self.iou, self.max_det = imgsz, conf, iou, max_det
        self.names = dict(names or getattr(model, "names", None)
                          or {i: str(i) for i in range(model.nc)})
        self.segment = isinstance(head, Segment)
        self.nm = head.nm if self.segment else 0
        self.anchors, self.strides = head.anchors, head.strides

    @staticmethod
    def _to_rgb(im) -> np.ndarray:
        """An RGB uint8 HWC array from an image file's path (through cv2), a
        PIL image or an array."""
        if isinstance(im, (str, Path)):
            arr = _cv2("reading image files").imread(str(im))
            if arr is None:
                raise FileNotFoundError(f"could not read image {im}")
            return np.ascontiguousarray(arr[..., ::-1])
        if hasattr(im, "convert"):  # PIL
            return np.asarray(im.convert("RGB"))
        return np.asarray(im)

    @torch.inference_mode()
    def forward(self, batch: np.ndarray):
        """One (b, size, size, 3) uint8 letterboxed batch -> (dets (b, max_det,
        6 + nm), n_valid (b,), protos or None) on the model's device."""
        x = torch.from_numpy(batch).to(self.device).permute(0, 3, 1, 2).float() / 255.0
        out = self.model(x, decode=False)
        levels, protos = out if self.segment else (out, None)
        levels = levels[:len(self.anchors)]  # DetectAux: the lead head's levels only
        dets, n_valid = nms_from_raw(levels, self.anchors, self.strides, conf_thres=self.conf,
                                     iou_thres=self.iou, max_det=self.max_det, nm=self.nm)
        return dets, n_valid, protos

    def __call__(self, imgs, size: Optional[int] = None) -> Detections:
        size = size or self.imgsz
        if not isinstance(imgs, (list, tuple)):
            imgs = [imgs]
        dt = tuple(Profile(device=self.device) for _ in range(3))
        with dt[0]:
            ims0 = [self._to_rgb(im) for im in imgs]
            batch = np.stack([letterbox(im, size)[0] for im in ims0])
        with dt[1]:
            dets, n_valid, protos = self.forward(batch)
        with dt[2], torch.inference_mode():
            out_dets, out_masks = [], []
            for i, im0 in enumerate(ims0):
                d = dets[i, :int(n_valid[i])].clone()
                masks = None
                if self.nm and len(d):
                    m = process_mask(protos[i], d[:, 6:6 + self.nm], d[:, :4], (size, size),
                                     upsample=True)
                    masks = (scale_image((size, size), m, im0.shape) > 0.5).cpu().numpy()
                d[:, :4] = scale_boxes((size, size), d[:, :4], im0.shape)
                out_dets.append(d.cpu().numpy())
                out_masks.append(masks)
        times = tuple(p.dt * 1e3 / len(ims0) for p in dt)
        return Detections(ims0, out_dets, out_masks, self.names, times)
