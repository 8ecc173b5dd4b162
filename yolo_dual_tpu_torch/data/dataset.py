"""YOLO-format detection and instance-segmentation dataset (port of
yolo_dual_tpu/data/dataset.py; reference utils/dataloaders.py:431-918,
utils/segment/dataloaders.py:82-331).

Frames are RGB uint8 (h, w, 3) `.npy` arrays under an `images/` directory,
labels the reference's txt files under the parallel `labels/` directory
(class, then a normalised box xywh or a normalised polygon x1 y1 x2 y2 ...).
The labels are checked once and cached beside the labels directory
(`labels.cache`, rebuilt when the files' hash or the cache's version
changes). Samples come at a fixed shape: `max_labels`-padded targets with a
validity mask and, for task="segment", an overlap-encoded (or per-instance)
mask plane at the image size / mask_ratio. Four paths, as in JAX:

- training on the device route (augment=True, device_aug=True): a 4-frame
  mosaic whose pixels are composed, warped, HSV-jittered and flipped on the
  device (kernels/augment.py:mosaic_warp_hsv). The sample carries the four
  resized frames zero-padded to imgsz (`aug_tiles`) and the geometry
  (`aug_dst`, `aug_off`, `aug_invm`, `aug_hsv`, `aug_flips`); its labels and
  masks are already warped on the host by the same matrix. A hyp the device
  route cannot run (mosaic < 1, mixup, copy_paste or cutout > 0) falls back
  to the host route with JAX's warning.
- training on the host route (augment=True, device_aug=False): the mosaic
  composed on a 2s x 2s canvas at fill 114, copy_paste, random_perspective,
  mixup with a second mosaic, or, when the mosaic coin fails, the letterboxed
  frame warped by random_perspective; then augment_hsv and the flips, all on
  the host (data/augment.py). For task="detect" the Albumentations adapter and
  cutout run too. The sample carries `image` uint8 (imgsz, imgsz, 3).
- validation with the letterbox kernel (device_preprocess=True): the raw
  frame (`image_raw`; every frame of one shape) and its labels mapped through
  the same letterbox geometry.
- validation with the host letterbox (device_preprocess=False): each frame
  resized so its long side is imgsz (INTER_AREA to shrink, INTER_LINEAR to
  enlarge, numpy copies of OpenCV's) and padded to imgsz x imgsz, or with
  rect=True to its aspect bucket's stride-aligned shape (`image`).

Every random draw comes from `self.rng` (Python's generator) in JAX's order,
and mixup's Beta(32, 32) ratio from `self.np_rng`, a numpy RandomState whose
stream is that of numpy's global generator JAX draws it from; with both
seeded as JAX's are, one seed gives JAX's samples. The `.npy` frames are
already the decoded-image cache that JAX's `cache_images="disk"` writes, so
that option reads them as they are; "ram" (or True) keeps the read frames in
memory.
"""

from __future__ import annotations

import hashlib
import math
import os
import random
from pathlib import Path
from typing import List, Optional

import numpy as np

from yolo_dual_tpu_torch.data.augment import (
    Albumentations,
    apply_perspective_to_labels,
    augment_hsv,
    copy_paste,
    cutout,
    letterbox,
    mixup,
    polygons2masks,
    polygons2masks_overlap,
    random_perspective,
    resize_area_u8,
    resize_linear_u8,
    sample_perspective_matrix,
    xyn2xy,
    xywhn2xyxy_np,
    xyxy2xywhn_np,
)
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_geometry
from yolo_dual_tpu_torch.utils.general import LOGGER

IMG_FORMATS = ("npy",)
CACHE_VERSION = "torch-npy-1"  # the port's own tag: the JAX package's caches are rebuilt, not read


def img2label_paths(img_paths):
    """images/... .npy -> labels/... .txt (reference utils/dataloaders.py:425)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def get_hash(paths):
    """Hash of the files' total size and their paths (JAX dataset.py:59)."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.sha256(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


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


def bucket_shape(aspect: float, imgsz: int, stride: int = 32):
    """The (h, w) of the rect bucket of h/w `aspect`: a wide one (aspect <= 1)
    at full width and its height rounded up to the stride, a tall one at full
    height (JAX dataset.py:184-191)."""
    if aspect <= 1.0:
        return min(int(math.ceil(imgsz * aspect / stride) * stride), imgsz), imgsz
    return imgsz, min(int(math.ceil(imgsz / aspect / stride) * stride), imgsz)


def bucket_index(r: float, aspects) -> int:
    """The bucket of a frame of h/w `r` that holds it at full long-side
    resolution: for a wide frame the smallest bucket aspect >= r, for a tall
    one the largest <= r; the square bucket when none does (JAX
    dataset.py:192-205)."""
    aspects = np.asarray(aspects)
    ok = np.flatnonzero(aspects >= r if r <= 1.0 else aspects <= r)
    if not len(ok):
        return int(np.argmin(np.abs(aspects - 1.0)))
    return int(ok[0] if r <= 1.0 else ok[-1])


class YoloDataset:
    """Map-style dataset yielding fixed-shape samples.

    sample dict: targets (M, 5) float32 [cls, xywh normalised to the sample's
    frame], tmask (M,) bool, shape0, ratio_pad and index; for task="segment"
    masks (h/r, w/r) float32 overlap-encoded (or (M, h/r, w/r) per instance
    with overlap=False); and the pixels: `aug_*` (the device route),
    `image_raw` (device_preprocess) or `image` uint8 (h, w, 3) (the host
    route and the host letterbox; (imgsz, imgsz), or the bucket's shape with
    rect).
    """

    # Aspect buckets of rect evaluation (JAX dataset.py:115-119): a fixed set of
    # stride-aligned (h, w) shapes, by h/w threshold, in place of the reference's
    # per-batch rectangles; a batch never straddles two (data/loader.py).
    BUCKET_ASPECTS = (0.5, 0.7, 1.0, 1.4, 2.0)

    def __init__(self, path, imgsz: int = 640, augment: bool = False, hyp: Optional[dict] = None,
                 task: str = "segment", mask_ratio: int = 4, overlap: bool = True,
                 max_labels: int = 120, prefix: str = "", single_cls: bool = False,
                 cache_images=False, rect: bool = False, stride: int = 32,
                 device_aug: bool = False, device_preprocess: bool = False):
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = dict(hyp or {})
        self.task = task
        self.mask_ratio = mask_ratio
        self.overlap = overlap
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.mosaic = self.augment and self.hyp.get("mosaic", 0) > 0
        self.mosaic_border = [-imgsz // 2, -imgsz // 2]
        self.device_aug = bool(device_aug) and augment
        h = self.hyp
        if self.device_aug and (h.get("mosaic", 0) < 1.0 or h.get("mixup", 0) > 0
                                or h.get("copy_paste", 0) > 0 or h.get("cutout", 0) > 0):
            LOGGER.warning(f"{prefix}device_aug needs mosaic=1.0 and no mixup/copy_paste/cutout; "
                           "falling back to host augmentation")
            self.device_aug = False
        self.rng = random.Random(0)
        self.np_rng = np.random.RandomState(0)
        self.albumentations = Albumentations(size=imgsz) if augment else None
        self.cache_ram = cache_images is True or cache_images == "ram"
        self.stride = stride

        self.im_files = self._discover(path, prefix)
        self.label_files = img2label_paths(self.im_files)
        cache = self._load_or_build_cache(prefix)
        self.labels = cache["labels"]
        self.segments = cache["segments"]
        self.shapes = cache["shapes"]
        self.n = len(self.im_files)
        self.indices = list(range(self.n))
        self.ims = [None] * self.n  # RAM image cache slots

        self.device_preprocess = bool(device_preprocess) and not augment
        if self.device_preprocess and len(self.shapes):
            uniq = {tuple(s) for s in self.shapes.astype(int).tolist()}
            if len(uniq) > 1:
                raise ValueError(
                    f"device_preprocess needs one uniform raw image shape, got {sorted(uniq)[:5]}"
                    f"{'...' if len(uniq) > 5 else ''}; use the host letterbox path")

        # rect: each frame's bucket is the smallest bucket shape that holds it at
        # its long side's full resolution; training (the square mosaic) ignores rect
        self.rect = rect and not self.augment
        self.bucket_of = self.bucket_shapes = None
        if self.rect and len(self.shapes):
            self.bucket_shapes = [bucket_shape(a, imgsz, stride) for a in self.BUCKET_ASPECTS]
            ar = self.shapes[:, 0].astype(np.float64) / self.shapes[:, 1]
            self.bucket_of = np.array([bucket_index(r, self.BUCKET_ASPECTS) for r in ar], np.int32)

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

    def _load_or_build_cache(self, prefix=""):
        """The checked labels, segments and shapes of every frame, from
        `labels.cache` when its version and hash match, else built and saved
        (JAX dataset.py:225-264)."""
        cache_path = Path(self.label_files[0]).parent.with_suffix(".cache")
        h = get_hash(self.label_files + self.im_files)
        if cache_path.is_file():
            try:
                cache = np.load(cache_path, allow_pickle=True).item()
                if cache.get("version") == CACHE_VERSION and cache.get("hash") == h:
                    nf, nm, ne, nc = cache["results"]
                    LOGGER.info(f"{prefix}cached labels: {nf} found, {nm} missing, {ne} empty, "
                                f"{nc} corrupt")
                    self.im_files = cache["im_files"]
                    self.label_files = img2label_paths(self.im_files)
                    return cache
            except Exception:
                pass
        labels, segments, shapes, keep = [], [], [], []
        nf = nm = ne = nc = 0
        for im_f, lb_f in zip(self.im_files, self.label_files):
            ok, lb, seg, shape, msg = verify_image_label(im_f, lb_f)
            if not ok:
                nc += 1
                LOGGER.warning(msg)
                continue
            nf += int(os.path.isfile(lb_f))
            nm += int(not os.path.isfile(lb_f))
            ne += int(len(lb) == 0)
            labels.append(lb)
            segments.append(seg)
            shapes.append(shape)
            keep.append(im_f)
        self.im_files = keep
        self.label_files = img2label_paths(keep)
        cache = {"labels": labels, "segments": segments, "shapes": np.array(shapes),
                 "im_files": keep, "hash": h, "version": CACHE_VERSION,
                 "results": (nf, nm, ne, nc)}
        try:
            np.save(str(cache_path.with_suffix("")), cache)
            cache_path.with_suffix(".npy").replace(cache_path)
        except OSError as e:
            LOGGER.warning(f"{prefix}label cache not saved to {cache_path}: {e}")
        LOGGER.info(f"{prefix}labels: {nf} found, {nm} missing, {ne} empty, {nc} corrupt")
        return cache

    def __len__(self):
        return self.n

    # -- image IO -----------------------------------------------------------
    def load_image(self, i):
        """Frame i resized so its long side is imgsz (JAX dataset.py:270-290):
        INTER_LINEAR when augmenting or enlarging, else INTER_AREA. Returns
        (frame, (h0, w0), (h, w)). With cache_images='ram' the read frames
        are kept in memory; with 'disk' they are read from their `.npy`
        files, which are JAX's disk cache already."""
        im = self.ims[i] if self.cache_ram else None
        if im is None:
            im = np.load(self.im_files[i])
            if self.cache_ram:
                self.ims[i] = im
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            resize = resize_linear_u8 if (self.augment or r > 1) else resize_area_u8
            im = resize(im, math.ceil(h0 * r), math.ceil(w0 * r))
        return im, (h0, w0), im.shape[:2]

    # -- mosaic -------------------------------------------------------------
    def load_mosaic(self, index, compose: bool = True):
        """4-frame mosaic (JAX dataset.py:293-365; reference
        utils/dataloaders.py:653-700). compose=True (the host route): the frames
        placed on a 2s x 2s canvas at fill 114, then copy_paste and
        random_perspective; returns (image, labels, segments). compose=False
        (the device route): the frames go out as tiles with their placement on
        the canvas, a perspective warp is drawn and the labels are warped here
        by it; returns ((tiles, dst, off, inv_m), labels, segments)."""
        s = self.imgsz
        yc, xc = (int(self.rng.uniform(-x, 2 * s + x)) for x in self.mosaic_border)
        indices = [index] + self.rng.choices(self.indices, k=3)
        self.rng.shuffle(indices)
        labels4, segments4 = [], []
        if compose:
            im4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        else:
            tiles = np.zeros((4, s, s, 3), np.uint8)
            dst = np.zeros((4, 4), np.float32)
            off = np.zeros((4, 2), np.float32)
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            if compose:
                im4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            else:
                tiles[i, :h, :w] = img
                dst[i] = (x1a, y1a, x2a, y2a)
                off[i] = (x1b - x1a, y1b - y1a)
            padw, padh = x1a - x1b, y1a - y1b
            labels = self.labels[idx].copy()
            segments = [se.copy() for se in self.segments[idx]]
            if labels.size:
                labels[:, 1:] = xywhn2xyxy_np(labels[:, 1:], w, h, padw, padh)
                segments = [xyn2xy(se, w, h, padw, padh) for se in segments]
            labels4.append(labels)
            segments4.extend(segments)
        labels4 = np.concatenate(labels4, 0)
        for x in (labels4[:, 1:], *segments4):
            np.clip(x, 0, 2 * s, out=x)
        hyp = self.hyp
        warp = dict(degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
                    scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                    perspective=hyp.get("perspective", 0.0), border=self.mosaic_border,
                    rng=self.rng)
        if compose:
            im4, labels4, segments4 = copy_paste(im4, labels4, segments4,
                                                 p=hyp.get("copy_paste", 0.0), rng=self.rng)
            return random_perspective(im4, labels4, segments4, **warp)
        M, sc, (width, height) = sample_perspective_matrix((s * 2, s * 2), **warp)
        labels4, segments4 = apply_perspective_to_labels(
            M, sc, warp["perspective"], labels4, segments4, width, height)
        inv_m = np.linalg.inv(M).astype(np.float32)
        return (tiles, dst, off, inv_m), labels4, segments4

    # -- fixed-shape sample assembly ----------------------------------------
    def __getitem__(self, index):
        hyp = self.hyp
        use_mosaic = self.mosaic and self.rng.random() < hyp.get("mosaic", 0.0)
        ratio_pad = None
        # JAX reads the (h, w) shape reversed here; the training routes keep it so
        shape0 = tuple(self.shapes[index][::-1]) if len(self.shapes) else (self.imgsz, self.imgsz)
        dev_geo = img = raw = None
        if use_mosaic and self.device_aug:
            dev_geo, labels, segments = self.load_mosaic(index, compose=False)
            # the host route's mixup coin: keeps the stream aligned with it (JAX :379)
            self.rng.random()
        elif use_mosaic:
            img, labels, segments = self.load_mosaic(index)
            if self.rng.random() < hyp.get("mixup", 0.0):
                img2, labels2, segments2 = self.load_mosaic(self.rng.choice(self.indices))
                img, labels, segments = mixup(img, labels, segments, img2, labels2, segments2,
                                              rng=self.np_rng)
        elif self.device_preprocess:
            raw = np.load(self.im_files[index])
            h0, w0 = raw.shape[:2]
            shape0 = (h0, w0)
            r, (left, top) = letterbox_geometry(h0, w0, self.imgsz, scaleup=False)
            ratio_pad = ((r, r), (left, top))
            labels = self.labels[index].copy()
            segments = [se.copy() for se in self.segments[index]]
            if labels.size:
                labels[:, 1:] = xywhn2xyxy_np(labels[:, 1:], r * w0, r * h0, left, top)
                segments = [xyn2xy(se, r * w0, r * h0, left, top) for se in segments]
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape0 = (h0, w0)
            new_shape = (self.bucket_shapes[self.bucket_of[index]]
                         if self.bucket_of is not None else self.imgsz)
            img, ratio, pad = letterbox(img, new_shape, scaleup=self.augment)
            ratio_pad = ((h / h0, w / w0), pad)
            labels = self.labels[index].copy()
            segments = [se.copy() for se in self.segments[index]]
            if labels.size:
                labels[:, 1:] = xywhn2xyxy_np(labels[:, 1:], ratio[0] * w, ratio[1] * h,
                                              pad[0], pad[1])
                segments = [xyn2xy(se, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
                            for se in segments]
            if self.augment:
                img, labels, segments = random_perspective(
                    img, labels, segments, degrees=hyp.get("degrees", 0.0),
                    translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
                    shear=hyp.get("shear", 0.0), perspective=hyp.get("perspective", 0.0),
                    rng=self.rng)

        nl = len(labels)
        h, w = (self.imgsz, self.imgsz) if img is None else img.shape[:2]
        masks = None
        if self.task == "segment":
            if nl:
                if self.overlap:
                    masks, sorted_idx = polygons2masks_overlap((h, w), segments,
                                                               downsample_ratio=self.mask_ratio)
                    labels = labels[sorted_idx]
                else:
                    masks = polygons2masks((h, w), segments, color=1,
                                           downsample_ratio=self.mask_ratio)
            else:
                mshape = (h // self.mask_ratio, w // self.mask_ratio)
                # a training sample without labels gets M empty instance planes where JAX
                # gives one plane its Loader cannot stack with the others (ROADMAP.md §C)
                masks = np.zeros((0, *mshape) if self.augment and not self.overlap else mshape,
                                 np.uint8)
        if nl:
            labels[:, 1:5] = xyxy2xywhn_np(labels[:, 1:5], w=w, h=h, clip=True, eps=1e-3)

        hsv_gains = np.ones(3, np.float32)
        flips = np.zeros(2, bool)
        if self.augment:
            if nl and self.task != "segment" and dev_geo is None:
                # detect only: both may drop labels, which would unpair them from masks
                img = np.ascontiguousarray(img)
                img, labels = self.albumentations(img, labels, rng=self.rng)
                if hyp.get("cutout", 0.0):
                    img, labels = cutout(img, labels, p=hyp["cutout"], rng=self.rng)
                nl = len(labels)
            if dev_geo is not None:
                # augment_hsv's gain draw; the gains are applied on the device
                hsv_gains = (np.array([self.rng.uniform(-1, 1) for _ in range(3)])
                             * [hyp.get("hsv_h", 0), hyp.get("hsv_s", 0), hyp.get("hsv_v", 0)]
                             + 1).astype(np.float32)
            else:
                img = augment_hsv(img, hyp.get("hsv_h", 0), hyp.get("hsv_s", 0),
                                  hyp.get("hsv_v", 0), rng=self.rng)
            if self.rng.random() < hyp.get("flipud", 0.0):
                flips[0] = True
                if img is not None:
                    img = np.flipud(img).copy()
                if nl:
                    labels[:, 2] = 1 - labels[:, 2]
                if masks is not None:
                    masks = np.flipud(masks).copy()
            if self.rng.random() < hyp.get("fliplr", 0.0):
                flips[1] = True
                if img is not None:
                    img = np.fliplr(img).copy()
                if nl:
                    labels[:, 1] = 1 - labels[:, 1]
                if masks is not None:
                    masks = np.fliplr(masks).copy()
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
               "shape0": np.array(shape0, np.int32),
               "ratio_pad": np.array(ratio_pad[1] if ratio_pad else (0, 0), np.float32),
               "index": np.int32(index)}
        if dev_geo is not None:
            tiles, dst, off, inv_m = dev_geo
            out.update(aug_tiles=tiles, aug_dst=dst, aug_off=off, aug_invm=inv_m,
                       aug_hsv=hsv_gains, aug_flips=flips)
        elif raw is not None:
            out["image_raw"] = raw
        else:
            out["image"] = img
        if masks is not None:
            if not self.overlap and masks.ndim == 3:
                inst = np.zeros((M, h // self.mask_ratio, w // self.mask_ratio), np.float32)
                inst[:kept] = masks[:kept]
                out["masks"] = inst
            else:
                out["masks"] = masks.astype(np.float32)
        return out


def quad_collate(samples):
    """The reference's collate_fn4 for detect samples (JAX dataset.py:516-556):
    every 4 consecutive samples become one at twice the size, alternately the
    first frame enlarged 2x (INTER_LINEAR; normalised labels unchanged) and
    the 2x2 mosaic of all four with their labels moved into its quadrants;
    targets hold 4x the per-sample rows. Samples with masks are refused, as
    in JAX."""
    out = []
    for gi in range(0, len(samples) - len(samples) % 4, 4):
        group = samples[gi:gi + 4]
        if any("masks" in s for s in group):
            raise ValueError("quad_collate supports detection samples only")
        M = group[0]["targets"].shape[0]
        targets = np.zeros((4 * M, 5), np.float32)
        tmask = np.zeros((4 * M,), bool)
        h, w = group[0]["image"].shape[:2]
        if (gi // 4) % 2 == 0:  # the enlarged first frame
            img = resize_linear_u8(group[0]["image"], 2 * h, 2 * w)
            targets[:M] = group[0]["targets"]
            tmask[:M] = group[0]["tmask"]
        else:  # the 2x2 mosaic
            img = np.zeros((2 * h, 2 * w, group[0]["image"].shape[2]), group[0]["image"].dtype)
            for q, s in enumerate(group):
                r, c = divmod(q, 2)
                img[r * h:(r + 1) * h, c * w:(c + 1) * w] = s["image"]
                t = s["targets"].copy()
                t[:, 1] = (t[:, 1] + c) / 2.0
                t[:, 2] = (t[:, 2] + r) / 2.0
                t[:, 3:5] = t[:, 3:5] / 2.0
                targets[q * M:(q + 1) * M] = t
                tmask[q * M:(q + 1) * M] = s["tmask"]
        merged = dict(group[0])
        merged.update(image=img, targets=targets, tmask=tmask)
        out.append(merged)
    return out


def create_dataloader(path, imgsz, batch_size, stride=32, single_cls=False, hyp=None,
                      augment=False, rect=False, prefix="", shuffle=False, mask_downsample_ratio=1,
                      overlap_mask=False, seed=0, task=None, cache_images=False, device_aug=False,
                      device_preprocess=False, collate=None):
    """(Loader, dataset) as JAX's create_dataloader builds them
    (data/dataset.py:560; reference utils/segment/dataloaders.py:23-78): the
    dataset's generators seeded with `seed` (JAX seeds its Python generator
    with it and draws mixup from numpy's global one, which init_seeds(seed)
    seeds), the loader shuffling with seed + epoch; task "segment" when a
    mask ratio or overlap masks are asked for. rect with augment is logged and
    ignored (the mosaic is square), as there."""
    from yolo_dual_tpu_torch.data.loader import Loader
    if rect and augment:
        LOGGER.info("rect=True with augment: mosaic pipeline is square; rect ignored")
    task = task or ("segment" if mask_downsample_ratio or overlap_mask else "detect")
    ds = YoloDataset(path, imgsz=imgsz, augment=augment, hyp=hyp, task=task,
                     mask_ratio=mask_downsample_ratio or 1, overlap=overlap_mask,
                     single_cls=single_cls, prefix=prefix, cache_images=cache_images,
                     rect=rect, stride=stride, device_aug=device_aug,
                     device_preprocess=device_preprocess)
    ds.rng.seed(seed)
    ds.np_rng.seed(seed)
    return Loader(ds, batch_size=batch_size, shuffle=shuffle, seed=seed, collate=collate), ds
