"""YOLO-format instance-segmentation dataset, validation side (port of
yolo_dual_tpu/data/dataset.py with device_preprocess=True; reference
utils/dataloaders.py:431-918, utils/segment/dataloaders.py:82-331).

Frames are RGB uint8 (h, w, 3) `.npy` arrays under an `images/` directory,
labels the reference's txt files under the parallel `labels/` directory
(class, then a normalised box xywh or a normalised polygon x1 y1 x2 y2 ...).
Every frame must have one shape: each sample carries the raw frame
(`image_raw`) for the letterbox kernel on the card, and its labels and
masks mapped through the same letterbox geometry on the host. Samples are
emitted at a fixed shape: `max_labels`-padded targets with a validity mask
and an overlap-encoded (or per-instance) mask plane at imgsz / mask_ratio.

Not ported yet (ROADMAP A item 2): the label cache, decoded image files, the
host letterbox path (device_preprocess=False), rect buckets, mosaic and the
host augmentations.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

import numpy as np

from yolo_dual_tpu_torch.data.augment import (
    polygons2masks,
    polygons2masks_overlap,
    xyn2xy,
    xywhn2xyxy_np,
    xyxy2xywhn_np,
)
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_geometry
from yolo_dual_tpu_torch.utils.general import LOGGER

IMG_FORMATS = ("npy",)


def img2label_paths(img_paths):
    """images/... .npy -> labels/... .txt (reference utils/dataloaders.py:425)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def verify_image_label(im_file: str, lb_file: str):
    """Validate one frame/label pair (reference utils/dataloaders.py:989-1040).
    The frame's shape is read from the `.npy` header without loading it.
    Returns (ok, labels (n, 5), segments list, shape (h, w), msg)."""
    segments = []
    try:
        im = np.load(im_file, mmap_mode="r")
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError(f"frame must be RGB uint8 (h, w, 3), got {im.dtype} {im.shape}")
        shape = (im.shape[1], im.shape[0])  # (w, h)
        if shape[0] <= 9 or shape[1] <= 9:
            raise ValueError(f"image size {shape} <10 pixels")
        if os.path.isfile(lb_file):
            with open(lb_file) as f:
                lb = [x.split() for x in f.read().strip().splitlines() if len(x)]
            if any(len(x) > 6 for x in lb):  # segments
                classes = np.array([x[0] for x in lb], dtype=np.float32)
                segments = [np.array(x[1:], dtype=np.float32).reshape(-1, 2) for x in lb]
                boxes = []
                for s in segments:
                    boxes.append([s[:, 0].min(), s[:, 1].min(), s[:, 0].max(), s[:, 1].max()])
                boxes = np.asarray(boxes, np.float32)
                xywh = np.concatenate([(boxes[:, :2] + boxes[:, 2:]) / 2,
                                       boxes[:, 2:] - boxes[:, :2]], 1)
                lb = np.concatenate((classes.reshape(-1, 1), xywh), 1)
            else:
                lb = np.array(lb, dtype=np.float32)
            if len(lb):
                if lb.shape[1] != 5:
                    raise ValueError(f"labels require 5 columns, {lb.shape[1]} detected")
                if (lb < 0).any():
                    raise ValueError(f"negative label values {lb[lb < 0]}")
                if (lb[:, 1:] > 1).any():
                    raise ValueError("non-normalized or out of bounds coordinates")
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < len(lb):
                    lb = lb[idx]
                    if segments:
                        segments = [segments[i] for i in idx]
            else:
                lb = np.zeros((0, 5), dtype=np.float32)
        else:
            lb = np.zeros((0, 5), dtype=np.float32)
        return True, lb, segments, (shape[1], shape[0]), ""
    except Exception as e:
        return False, np.zeros((0, 5), np.float32), [], (0, 0), f"ignoring corrupt image/label {im_file}: {e}"


class YoloDataset:
    """Map-style validation dataset yielding fixed-shape samples.

    sample dict: image_raw uint8 (h0, w0, 3) RGB, targets (M, 5) float32
    [cls, xywh normalised to the letterboxed imgsz frame], tmask (M,) bool,
    masks (imgsz/r, imgsz/r) float32 overlap-encoded (or (M, imgsz/r,
    imgsz/r) per instance with overlap=False), shape0 (h0, w0), ratio_pad
    (left, top) and index.
    """

    def __init__(self, path, imgsz: int = 640, augment: bool = False, mask_ratio: int = 4,
                 overlap: bool = True, max_labels: int = 120, prefix: str = "",
                 single_cls: bool = False, device_preprocess: bool = True):
        if augment or not device_preprocess:
            raise NotImplementedError(
                "YoloDataset: only the validation path (augment=False, device_preprocess=True) "
                "is ported; mosaic, host augmentation and the host letterbox come with "
                "ROADMAP A item 2")
        self.imgsz = imgsz
        self.mask_ratio = mask_ratio
        self.overlap = overlap
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.im_files = self._discover(path, prefix)
        self.labels, self.segments, shapes = [], [], []
        nf = nm = ne = nc = 0
        keep = []
        for im_f, lb_f in zip(self.im_files, img2label_paths(self.im_files)):
            ok, lb, seg, shape, msg = verify_image_label(im_f, lb_f)
            if not ok:
                nc += 1
                LOGGER.warning(msg)
                continue
            nf += int(os.path.isfile(lb_f))
            nm += int(not os.path.isfile(lb_f))
            ne += int(len(lb) == 0)
            self.labels.append(lb)
            self.segments.append(seg)
            shapes.append(shape)
            keep.append(im_f)
        LOGGER.info(f"{prefix}labels: {nf} found, {nm} missing, {ne} empty, {nc} corrupt")
        self.im_files = keep
        self.label_files = img2label_paths(keep)
        self.shapes = np.array(shapes)
        self.n = len(self.im_files)
        uniq = {tuple(s) for s in self.shapes.astype(int).tolist()}
        if len(uniq) > 1:
            raise ValueError(
                f"device_preprocess needs one uniform raw image shape, got {sorted(uniq)[:5]}"
                f"{'...' if len(uniq) > 5 else ''}")

    @staticmethod
    def _discover(path, prefix="") -> List[str]:
        files = []
        for p in path if isinstance(path, list) else [path]:
            p = Path(p)
            if p.is_dir():
                files += [str(f) for f in sorted(p.rglob("*.*"))]
            elif p.is_file():
                with open(p) as f:
                    parent = str(p.parent) + os.sep
                    files += [x.replace("./", parent) if x.startswith("./") else x
                              for x in f.read().strip().splitlines()]
            else:
                raise FileNotFoundError(f"{prefix}{p} does not exist")
        im_files = sorted(x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
        if not im_files:
            raise FileNotFoundError(f"{prefix}no .npy frames found in {path}")
        return im_files

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        raw = np.load(self.im_files[index])
        h0, w0 = raw.shape[:2]
        s = self.imgsz
        r, (left, top) = letterbox_geometry(h0, w0, s, scaleup=False)
        labels = self.labels[index].copy()
        segments = [se.copy() for se in self.segments[index]]
        if labels.size:
            labels[:, 1:] = xywhn2xyxy_np(labels[:, 1:], r * w0, r * h0, left, top)
            segments = [xyn2xy(se, r * w0, r * h0, left, top) for se in segments]

        nl = len(labels)
        h = w = s
        if nl:
            if self.overlap:
                masks, sorted_idx = polygons2masks_overlap((h, w), segments,
                                                           downsample_ratio=self.mask_ratio)
                labels = labels[sorted_idx]
            else:
                masks = polygons2masks((h, w), segments, color=1,
                                       downsample_ratio=self.mask_ratio)
            labels[:, 1:5] = xyxy2xywhn_np(labels[:, 1:5], w=w, h=h, clip=True, eps=1e-3)
        else:
            masks = np.zeros((h // self.mask_ratio, w // self.mask_ratio), np.uint8)
        if self.single_cls and nl:
            labels[:, 0] = 0

        M = self.max_labels
        targets = np.zeros((M, 5), np.float32)
        tmask = np.zeros((M,), bool)
        kept = min(nl, M)
        if nl > M:
            LOGGER.warning(f"sample {index}: {nl} labels exceed max_labels={M}; truncating")
        if kept:
            targets[:kept] = labels[:kept]
            tmask[:kept] = True
        out = {"targets": targets, "tmask": tmask,
               "shape0": np.array((h0, w0), np.int32),
               "ratio_pad": np.array((left, top), np.float32),
               "index": np.int32(index), "image_raw": raw}
        if not self.overlap and masks.ndim == 3:
            inst = np.zeros((M, h // self.mask_ratio, w // self.mask_ratio), np.float32)
            inst[:kept] = masks[:kept]
            out["masks"] = inst
        else:
            out["masks"] = masks.astype(np.float32)
        return out
