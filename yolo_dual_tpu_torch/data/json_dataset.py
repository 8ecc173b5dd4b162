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
`kernels/preprocess.py:semantic_preprocess` fits them on the card. The host
route's paired augmentation (`augment=True`, JAX `_augment_pair`) and the
PNG -> JSON converters are not ported yet (ROADMAP A item 4, training).
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from yolo_dual_tpu_torch.data.augment import resize_linear_u8

IMG_EXTS = (".npy", ".jpg", ".jpeg", ".png", ".bmp")
_TRAINING_SLICE = "the semantic training slice, ROADMAP A item 4"


def _frames(img_dir) -> List[Path]:
    """The frames of a directory, sorted; a mask cache `*.json.npy` kept
    beside them is not one."""
    return [p for p in sorted(Path(img_dir).iterdir())
            if p.suffix.lower() in IMG_EXTS and not p.name.endswith(".json.npy")]


def mask_to_json(mask_path, json_path, class_names: Optional[List[str]] = None):
    """PNG class-id mask -> JSON record (JAX json_dataset.py:31): not ported yet."""
    raise NotImplementedError(f"mask_to_json decodes PNG masks: not ported yet ({_TRAINING_SLICE})")


def batch_convert_masks_to_json(mask_dir, json_dir, class_names=None):
    """A directory of PNG masks -> JSON records (JAX json_dataset.py:48): not ported yet."""
    raise NotImplementedError(
        f"batch_convert_masks_to_json decodes PNG masks: not ported yet ({_TRAINING_SLICE})")


def verify_json_masks(img_dir, json_dir) -> Tuple[bool, List[str]]:
    """(every image has a JSON mask, the names of those that lack one)."""
    missing = [im.name for im in _frames(img_dir)
               if not (Path(json_dir) / (im.stem + ".json")).exists()]
    return not missing, missing


def _load_json_mask(json_path, cache: bool = True) -> np.ndarray:
    """A JSON record's mask, uint8 of its `shape`; read from the `.json.npy`
    sidecar when that is not older than the JSON, else parsed (with `json`,
    JAX's fallback where its native scanner is absent) and, with `cache`,
    saved there."""
    npy = Path(str(json_path) + ".npy")
    if cache and npy.exists() and npy.stat().st_mtime >= Path(json_path).stat().st_mtime:
        return np.load(npy)
    data = json.loads(Path(json_path).read_bytes())
    mask = np.asarray(data["mask_data"], np.uint8).reshape(data["shape"])
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
    `device_preprocess`, the per-sample draws made from `random.Random(seed)`
    in JAX's order (none unless `augment`)."""

    def __init__(self, img_dir, json_dir, img_size: int = 640, augment: bool = False,
                 num_classes: int = 12, seed: int = 0,
                 device_preprocess: bool = False):
        if augment and not device_preprocess:
            raise NotImplementedError("the host route's paired augmentation (warpAffine, "
                                      f"GaussianBlur) is not ported yet ({_TRAINING_SLICE}); "
                                      "use device_preprocess=True")
        self.img_dir = Path(img_dir)
        self.json_dir = Path(json_dir)
        self.img_size = img_size
        self.augment = augment
        self.num_classes = num_classes
        self.device_preprocess = device_preprocess
        self.rng = random.Random(seed)
        # JAX's default aug_params, the keys the device route's draws read
        self.p = dict(hflip=0.5, brightness=0.2, contrast=0.2)
        self.items = [(im, self.json_dir / (im.stem + ".json")) for im in _frames(self.img_dir)
                      if (self.json_dir / (im.stem + ".json")).exists()]
        if not self.items:
            raise FileNotFoundError(f"no (image, json) pairs under {img_dir} / {json_dir}")

    def __len__(self):
        return len(self.items)

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
        img, mask, _ = resize_and_pad(img, mask, self.img_size)
        mask = np.clip(mask, 0, self.num_classes - 1)
        return {"image": img, "mask": mask.astype(np.int32)}

    def class_weights(self) -> np.ndarray:
        from yolo_dual_tpu_torch.losses.semantic import seg_labels_to_class_weights
        return seg_labels_to_class_weights([j for _, j in self.items], self.num_classes)


def create_json_segment_dataloader(img_dir, json_dir, img_size=640, batch_size=16,
                                   augment=False, num_classes=12, shuffle=None, seed=0,
                                   device_preprocess=False):
    """(Loader, dataset) as JAX's constructor builds them (json_dataset.py:204),
    with the port's Loader: a final partial batch is padded and carries
    `n_valid`, as JAX's val loader (drop_last=False) gives it."""
    from yolo_dual_tpu_torch.data.loader import Loader
    ds = JSONSegmentDataset(img_dir, json_dir, img_size, augment, num_classes,
                            seed=seed, device_preprocess=device_preprocess)
    loader = Loader(ds, batch_size=batch_size, shuffle=augment if shuffle is None else shuffle,
                    seed=seed)
    return loader, ds
