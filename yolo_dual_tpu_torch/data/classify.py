"""Classification dataset and transforms (port of
yolo_dual_tpu/data/classify.py; reference utils/dataloaders.py:1162-1227,
utils/augmentations.py:305-396).

An ImageFolder layout (root/<class>/<image>), with RAM and disk caches and
the native train pipeline (RandomResizedCrop, flips, ColorJitter, ImageNet
normalisation) in numpy: the resizes are `data/augment.py:resize_linear_u8`,
exact against cv2's INTER_LINEAR, so no transform needs cv2. The JAX package
uses albumentations where it is installed; it is not, on either machine, and
JAX then runs these same native transforms. The port's dataset runs only
these; `classify_albumentations` builds JAX's pipeline for a caller who has
the package.

Image files (IMG_EXTS) are read with cv2 where it imports. A `.npy` file under
a class folder is an RGB uint8 HWC frame, unless an image file shares its
stem: it is then that image's disk cache, BGR as JAX writes it, and no
sample of its own. A card without cv2 trains from `.npy` folders.
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Optional

import numpy as np

from yolo_dual_tpu_torch.data.augment import resize_linear_u8
from yolo_dual_tpu_torch.utils.general import LOGGER

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMG_EXTS = (".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp")


def normalize_imagenet(im: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> float32 normalized (reference IMAGENET_MEAN/STD)."""
    return (im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_imagenet(im: np.ndarray) -> np.ndarray:
    return im * IMAGENET_STD + IMAGENET_MEAN


def center_crop_resize(im: np.ndarray, size: int) -> np.ndarray:
    """Reference CenterCrop (utils/augmentations.py:375-385): crop the
    largest centered square, resize it to (size, size), INTER_LINEAR."""
    h, w = im.shape[:2]
    m = min(h, w)
    top, left = (h - m) // 2, (w - m) // 2
    return resize_linear_u8(im[top:top + m, left:left + m], size, size)


def random_resized_crop(im: np.ndarray, size: int, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3), rng: Optional[random.Random] = None) -> np.ndarray:
    """torchvision/albumentations RandomResizedCrop semantics: up to 10 tries
    of a crop with area in `scale`·area and a log-uniform aspect in `ratio`
    (two `uniform` draws a try, then two `randint` for the corner of the
    first that fits), else the center crop."""
    rng = rng or random
    h, w = im.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * ar)))
        ch = int(round(math.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw)
            y0 = rng.randint(0, h - ch)
            return resize_linear_u8(im[y0:y0 + ch, x0:x0 + cw], size, size)
    return center_crop_resize(im, size)


def color_jitter(im: np.ndarray, jitter: float = 0.4,
                 rng: Optional[random.Random] = None) -> np.ndarray:
    """Brightness, contrast and saturation factors U[1-j, 1+j], drawn in that
    order, hue 0 (the reference's ColorJitter(j, j, j, 0)), in float32."""
    rng = rng or random
    x = im.astype(np.float32)
    b = rng.uniform(1 - jitter, 1 + jitter)
    c = rng.uniform(1 - jitter, 1 + jitter)
    s = rng.uniform(1 - jitter, 1 + jitter)
    x = x * b
    mean = x.mean()
    x = (x - mean) * c + mean
    gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
    x = (x - gray[..., None]) * s + gray[..., None]
    return np.clip(x, 0, 255).astype(np.uint8)


def classify_transforms(im: np.ndarray, size: int = 224) -> np.ndarray:
    """Eval transform (reference classify_transforms, augmentations.py:348):
    CenterCrop(size) + /255 + ImageNet normalize. RGB HWC in/out."""
    return normalize_imagenet(center_crop_resize(im, size))


def classify_albumentations(augment: bool = True, size: int = 224, scale=(0.08, 1.0),
                            ratio=(0.75, 4 / 3), hflip: float = 0.5, vflip: float = 0.0,
                            jitter: float = 0.4):
    """An albumentations pipeline where the package is installed (reference
    utils/augmentations.py:305-345; JAX data/classify.py:93), else None: the
    dataset then runs its native transforms, as JAX's does."""
    try:
        import albumentations as A
    except ImportError:
        return None
    if augment:
        T = [A.RandomResizedCrop(height=size, width=size, scale=scale, ratio=ratio)]
        if hflip > 0:
            T += [A.HorizontalFlip(p=hflip)]
        if vflip > 0:
            T += [A.VerticalFlip(p=vflip)]
        if jitter > 0:
            T += [A.ColorJitter(jitter, jitter, jitter, 0)]
    else:
        T = [A.SmallestMaxSize(max_size=size), A.CenterCrop(height=size, width=size)]
    T += [A.Normalize(mean=list(IMAGENET_MEAN), std=list(IMAGENET_STD))]
    LOGGER.info("albumentations: " + ", ".join(type(t).__name__ for t in T))
    return A.Compose(T)


def _imread(f) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {f} needs OpenCV (cv2), which is not installed; save the "
                          "frames as RGB uint8 .npy files to read them without it") from e
    im = cv2.imread(str(f))
    if im is None:
        raise FileNotFoundError(f"could not read image {f}")
    return im


class ClassificationDataset:
    """ImageFolder-style dataset (root/<class>/<image>) with RAM/disk caching
    and the train/eval transforms (reference utils/dataloaders.py:1162-1227).

    Emits {"image": float32 (size, size, 3) ImageNet-normalized RGB,
    "label": int32}. The augmenting draws come from `random.Random(seed)` in
    JAX's order: random_resized_crop's, then `random()` for the horizontal
    flip, `random()` for the vertical one only when vflip > 0, and the
    jitter's three `uniform`s."""

    def __init__(self, root, imgsz: int = 224, augment: bool = False,
                 cache: bool | str = False, seed: int = 0,
                 scale=(0.08, 1.0), hflip: float = 0.5, vflip: float = 0.0,
                 jitter: float = 0.4):
        self.root = Path(root)
        self.classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        assert self.classes, f"no class directories under {root}"
        self.samples = []  # [file, class, disk cache or None, RAM copy]
        for ci, c in enumerate(self.classes):
            files = sorted(f for f in (self.root / c).rglob("*.*")
                           if f.suffix.lower() in IMG_EXTS + (".npy",))
            images = {f.with_suffix("") for f in files if f.suffix.lower() != ".npy"}
            for f in files:
                if f.suffix.lower() != ".npy":
                    self.samples.append([f, ci, f.with_suffix(".npy"), None])
                elif f.with_suffix("") not in images:  # a frame, not an image's cache
                    self.samples.append([f, ci, None, None])
        assert self.samples, f"no images under {root}"
        self.imgsz = imgsz
        self.augment = augment
        self.cache_ram = cache is True or cache == "ram"
        self.cache_disk = cache == "disk"
        self.rng = random.Random(seed)
        self.scale, self.hflip, self.vflip, self.jitter = scale, hflip, vflip, jitter

    def __len__(self):
        return len(self.samples)

    def _read(self, i) -> np.ndarray:
        """The RGB uint8 frame of sample i."""
        f, _, fn, im = self.samples[i]
        if fn is None:  # an RGB .npy frame
            if im is None:
                im = np.load(f)
                if self.cache_ram:
                    self.samples[i][3] = im
            return im
        if self.cache_ram:
            if im is None:
                im = self.samples[i][3] = _imread(f)
        elif self.cache_disk:
            if not fn.exists():
                np.save(fn.as_posix(), _imread(f))
            im = np.load(fn)
        else:
            im = _imread(f)
        return np.ascontiguousarray(im[..., ::-1])  # BGR -> RGB, as cv2.cvtColor

    def __getitem__(self, i):
        im = self._read(i)
        label = self.samples[i][1]
        if self.augment:
            im = random_resized_crop(im, self.imgsz, scale=self.scale, rng=self.rng)
            if self.hflip > 0 and self.rng.random() < self.hflip:
                im = np.fliplr(im).copy()
            if self.vflip > 0 and self.rng.random() < self.vflip:
                im = np.flipud(im).copy()
            if self.jitter > 0:
                im = color_jitter(im, self.jitter, self.rng)
            im = normalize_imagenet(im)
        else:
            im = classify_transforms(im, self.imgsz)
        return {"image": im, "label": np.int32(label)}


def create_classification_dataloader(path, imgsz: int = 224, batch_size: int = 16,
                                     augment: bool = True, cache: bool | str = False,
                                     shuffle: bool = True, seed: int = 0):
    """Reference-compatible constructor (utils/dataloaders.py:1196-1220): the
    dataset behind a Loader that drops a final partial batch when it
    augments. Returns (Loader, dataset)."""
    from yolo_dual_tpu_torch.data.loader import Loader
    ds = ClassificationDataset(path, imgsz=imgsz, augment=augment, cache=cache, seed=seed)
    loader = Loader(ds, batch_size=min(batch_size, len(ds)), shuffle=shuffle,
                    seed=seed, drop_last=augment)
    return loader, ds
