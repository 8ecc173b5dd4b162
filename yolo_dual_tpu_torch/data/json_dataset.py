"""JSON dense-mask semantic-segmentation dataset (port of
yolo_dual_tpu/data/json_dataset.py; reference
unet-lite/Resnet50/seg_diceloss_Resnet50.py:88-378).

Layout: an images directory and a JSON directory with one record per image,
`{stem}.json` = {filename, shape, dtype, class_names, mask_data (flat list)}.
Frames are RGB uint8 `.npy` arrays (image files are decoded with cv2 where it
is installed). A parsed mask is cached beside its JSON as `{stem}.json.npy`.

Two routes, as in JAX: the host route resizes and pads each sample to the
training size (`resize_and_pad`: INTER_LINEAR for the frame, INTER_NEAREST
for the mask, numpy copies of OpenCV's); the device route
(`device_preprocess=True`) ships the native frame and mask, and
`kernels/preprocess.py:semantic_preprocess` fits them on the card. With
`augment`, the host route applies JAX's paired augmentation (`_augment_pair`:
flips, rotation, brightness, contrast, blur, crop; data/augment.py's numpy
copies of cv2.warpAffine and cv2.GaussianBlur) and the device route draws the
flip, brightness and contrast that semantic_preprocess applies, each from the
dataset's `random.Random(seed)` in JAX's order.

Masks are parsed with the native scanner (native/fastmask.cpp) where it
builds, else with `json`, as JAX does. `mask_to_json` and
`batch_convert_masks_to_json` turn class-id masks (PNG through cv2 where it is
installed, or `.npy`) into JSON records byte for byte as JAX writes them.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from yolo_dual_tpu_torch.data.augment import (gaussian_blur5_u8, get_rotation_matrix_2d,
                                              resize_linear_u8, warp_affine_u8)
from yolo_dual_tpu_torch.utils.general import LOGGER

IMG_EXTS = (".npy", ".jpg", ".jpeg", ".png", ".bmp")
MASK_EXTS = (".png", ".npy")
# JAX's aug_params defaults (json_dataset.py:127-128)
AUG_PARAMS = dict(hflip=0.5, vflip=0.0, degrees=10.0, rot_p=0.3, brightness=0.2,
                  contrast=0.2, blur_p=0.1, crop_p=0.3, crop_scale=0.8)


def _frames(img_dir) -> List[Path]:
    """The frames of a directory, sorted; a mask cache `*.json.npy` kept
    beside them is not one."""
    return [p for p in sorted(Path(img_dir).iterdir())
            if p.suffix.lower() in IMG_EXTS and not p.name.endswith(".json.npy")]


def read_mask(path) -> np.ndarray:
    """A class-id mask: a `.npy` array, or an image file read as grayscale
    through cv2 (cv2.IMREAD_GRAYSCALE, as JAX reads it)."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        return np.load(path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading image masks needs OpenCV (cv2), which is not "
                          "installed; store masks as uint8 .npy arrays") from e
    mask = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if mask is None:
        raise FileNotFoundError(path)
    return mask


def mask_to_json(mask_path, json_path, class_names: Optional[List[str]] = None):
    """Class-id mask -> JSON record (JAX json_dataset.py:31; reference
    seg_diceloss_Resnet50.py:203-226), written as JAX's json.dump writes it."""
    mask = read_mask(mask_path)
    data = {
        "filename": os.path.basename(str(mask_path)),
        "shape": list(mask.shape),
        "dtype": str(mask.dtype),
        "class_names": class_names or [],
        "mask_data": mask.flatten().astype(int).tolist(),
    }
    with open(json_path, "w") as f:
        json.dump(data, f)
    return json_path


def batch_convert_masks_to_json(mask_dir, json_dir, class_names=None):
    """Convert a directory of PNG (or `.npy`) masks (JAX json_dataset.py:48)."""
    json_dir = Path(json_dir)
    json_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for m in sorted(Path(mask_dir).iterdir()):
        if m.suffix.lower() in MASK_EXTS:
            mask_to_json(m, json_dir / (m.stem + ".json"), class_names)
            n += 1
    LOGGER.info(f"converted {n} masks -> {json_dir}")
    return n


def verify_json_masks(img_dir, json_dir) -> Tuple[bool, List[str]]:
    """(every image has a JSON mask, the names of those that lack one)."""
    missing = [im.name for im in _frames(img_dir)
               if not (Path(json_dir) / (im.stem + ".json")).exists()]
    return not missing, missing


def _load_json_mask(json_path, cache: bool = True) -> np.ndarray:
    """A JSON record's mask, uint8 of its `shape`; read from the `.json.npy`
    sidecar when that is not older than the JSON, else parsed (by the native
    scanner, or by `json` where it did not build, as JAX does) and, with
    `cache`, saved there."""
    npy = Path(str(json_path) + ".npy")
    if cache and npy.exists() and npy.stat().st_mtime >= Path(json_path).stat().st_mtime:
        return np.load(npy)
    from yolo_dual_tpu_torch.native import parse_mask_json_bytes
    mask = parse_mask_json_bytes(Path(json_path).read_bytes()).copy()
    if cache:
        try:
            np.save(npy, mask)
        except OSError:
            pass
    return mask


def resize_nearest_u8(mask: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(mask, (nw, nh), interpolation=cv2.INTER_NEAREST): source
    index floor(i * (1 / (n_out / n_in))) in float64, as OpenCV computes it."""
    h, w = mask.shape[:2]
    ry = np.minimum(np.floor(np.arange(nh) * (1.0 / (nh / h))).astype(np.int64), h - 1)
    rx = np.minimum(np.floor(np.arange(nw) * (1.0 / (nw / w))).astype(np.int64), w - 1)
    return mask[ry][:, rx]


def resize_and_pad(img: np.ndarray, mask: Optional[np.ndarray], size: int,
                   img_fill: int = 128, mask_fill: int = 0):
    """Aspect-preserving resize + centre pad of a frame (INTER_LINEAR) and its
    mask (INTER_NEAREST) onto (size, size) (JAX json_dataset.py:91).
    Returns (image, mask or None, (scale, (left, top)))."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    top, left = (size - nh) // 2, (size - nw) // 2
    out = np.full((size, size, 3), img_fill, np.uint8)
    out[top:top + nh, left:left + nw] = resize_linear_u8(img, nh, nw)
    mout = None
    if mask is not None:
        mout = np.full((size, size), mask_fill, np.uint8)
        mout[top:top + nh, left:left + nw] = resize_nearest_u8(mask, nh, nw)
    return out, mout, (scale, (left, top))


def read_frame(path) -> np.ndarray:
    """An RGB uint8 frame: a `.npy` array, or an image file through cv2."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        return np.load(path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading image files needs OpenCV (cv2), which is not "
                          "installed; store frames as RGB uint8 .npy arrays") from e
    im = cv2.imread(str(path))
    if im is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(im[..., ::-1])


class JSONSegmentDataset:
    """Fixed-shape semantic samples (JAX json_dataset.py:110):
    {'image': (s, s, 3) uint8, 'mask': (s, s) int32} on the host route;
    {'image_raw', 'mask_raw', 'flip', 'bright', 'contr'} with
    `device_preprocess`. With `augment` the host route augments each pair
    (`_augment_pair`) and the device route draws its flip / brightness /
    contrast; every draw comes from `random.Random(seed)` in JAX's order.
    `aug_params` overrides JAX's defaults (AUG_PARAMS)."""

    def __init__(self, img_dir, json_dir, img_size: int = 640, augment: bool = False,
                 num_classes: int = 12, aug_params: Optional[dict] = None, seed: int = 0,
                 device_preprocess: bool = False):
        self.img_dir = Path(img_dir)
        self.json_dir = Path(json_dir)
        self.img_size = img_size
        self.augment = augment
        self.num_classes = num_classes
        self.device_preprocess = device_preprocess
        self.rng = random.Random(seed)
        self.p = {**AUG_PARAMS, **(aug_params or {})}
        self.items = [(im, self.json_dir / (im.stem + ".json")) for im in _frames(self.img_dir)
                      if (self.json_dir / (im.stem + ".json")).exists()]
        if not self.items:
            raise FileNotFoundError(f"no (image, json) pairs under {img_dir} / {json_dir}")

    def __len__(self):
        return len(self.items)

    def _augment_pair(self, img, mask):
        """JAX json_dataset.py:143: hflip, vflip, rotation (INTER_LINEAR with
        border 128 for the frame, INTER_NEAREST with border 0 for the mask),
        brightness and contrast in float32, a 5x5 Gaussian blur, a crop."""
        p, rng = self.p, self.rng
        if rng.random() < p["hflip"]:
            img, mask = np.fliplr(img).copy(), np.fliplr(mask).copy()
        if rng.random() < p["vflip"]:
            img, mask = np.flipud(img).copy(), np.flipud(mask).copy()
        if rng.random() < p["rot_p"]:
            a = rng.uniform(-p["degrees"], p["degrees"])
            h, w = img.shape[:2]
            m = get_rotation_matrix_2d(a, (w / 2, h / 2), 1.0)
            img = warp_affine_u8(img, m, (w, h), linear=True, border=128)
            mask = warp_affine_u8(mask, m, (w, h), linear=False, border=0)
        if p["brightness"]:
            f = 1.0 + rng.uniform(-p["brightness"], p["brightness"])
            img = np.clip(img.astype(np.float32) * f, 0, 255).astype(np.uint8)
        if p["contrast"]:
            f = 1.0 + rng.uniform(-p["contrast"], p["contrast"])
            mean = img.mean()
            img = np.clip((img.astype(np.float32) - mean) * f + mean, 0, 255).astype(np.uint8)
        if rng.random() < p["blur_p"]:
            img = gaussian_blur5_u8(img)
        if rng.random() < p["crop_p"]:
            h, w = img.shape[:2]
            s = rng.uniform(p["crop_scale"], 1.0)
            ch, cw = int(h * s), int(w * s)
            y0 = rng.randint(0, h - ch)
            x0 = rng.randint(0, w - cw)
            img, mask = img[y0:y0 + ch, x0:x0 + cw], mask[y0:y0 + ch, x0:x0 + cw]
        return img, mask

    def __getitem__(self, i):
        im_path, json_path = self.items[i]
        img = read_frame(im_path)
        mask = _load_json_mask(json_path)
        if mask.shape[:2] != img.shape[:2]:
            mask = resize_nearest_u8(mask, *img.shape[:2])
        if self.device_preprocess:
            p, rng = self.p, self.rng
            mask = np.clip(mask, 0, self.num_classes - 1)
            return {"image_raw": img, "mask_raw": mask.astype(np.int32),
                    "flip": self.augment and rng.random() < p["hflip"],
                    "bright": np.float32(1.0 + rng.uniform(-p["brightness"], p["brightness"])
                                         if self.augment and p["brightness"] else 1.0),
                    "contr": np.float32(1.0 + rng.uniform(-p["contrast"], p["contrast"])
                                        if self.augment and p["contrast"] else 1.0)}
        if self.augment:
            img, mask = self._augment_pair(img, mask)
        img, mask, _ = resize_and_pad(img, mask, self.img_size)
        mask = np.clip(mask, 0, self.num_classes - 1)
        return {"image": img, "mask": mask.astype(np.int32)}

    def class_weights(self) -> np.ndarray:
        from yolo_dual_tpu_torch.losses.semantic import seg_labels_to_class_weights
        return seg_labels_to_class_weights([j for _, j in self.items], self.num_classes)


def create_json_segment_dataloader(img_dir, json_dir, img_size=640, batch_size=16,
                                   augment=False, num_classes=12, workers=0, shuffle=None,
                                   seed=0, drop_last=True, device_preprocess=False):
    """(Loader, dataset) as JAX's constructor builds them (json_dataset.py:204):
    shuffled when augmenting, and with `drop_last` (the default, the
    reference's) a final partial batch is dropped; without it, it is padded
    and carries `n_valid`. `workers` is accepted for parity: one prefetch
    thread reads the samples."""
    from yolo_dual_tpu_torch.data.loader import Loader
    ds = JSONSegmentDataset(img_dir, json_dir, img_size, augment, num_classes,
                            seed=seed, device_preprocess=device_preprocess)
    loader = Loader(ds, batch_size=batch_size, shuffle=augment if shuffle is None else shuffle,
                    seed=seed, drop_last=drop_last)
    return loader, ds
