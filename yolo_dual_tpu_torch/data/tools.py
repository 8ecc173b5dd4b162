"""Dataset tools and the synthetic CamVid-style scene (port of
yolo_dual_tpu/data/tools.py).

The tools are the reference's (utils/dataloaders.py): flatten_recursive
(:919), extract_boxes (:929), autosplit (:963) and a HUBDatasetStats-style
summary (:1041). They act on the port's datasets, whose frames are RGB uint8
`.npy` files (data/dataset.py): where JAX reads and writes image files with
cv2, extract_boxes writes its crops as `.npy` frames, which the port's
classification dataset reads as samples. Files, splits and counts are
JAX's.

The scene's arrays equal JAX's (:118-163, the data of
tests/test_semantic_golden.py's learning goldens); it is written with `.npy`
frames, where JAX writes PNG through cv2, beside the same JSON dense masks.
"""

from __future__ import annotations

import json
import random
import shutil
from pathlib import Path

import numpy as np

from yolo_dual_tpu_torch.data.dataset import IMG_FORMATS, YoloDataset, img2label_paths
from yolo_dual_tpu_torch.utils.general import LOGGER

def _frames(path: Path):
    return [f for f in path.rglob("*.*") if f.suffix[1:].lower() in IMG_FORMATS]


def flatten_recursive(path) -> Path:
    """Copy every file under `path` into a flat `<path>_flat` directory
    (reference :919-927)."""
    new_path = Path(str(path) + "_flat")
    if new_path.exists():
        shutil.rmtree(new_path)
    new_path.mkdir(parents=True)
    for f in Path(path).rglob("*.*"):
        if f.is_file():
            shutil.copyfile(f, new_path / f.name)
    return new_path


def extract_boxes(path) -> Path:
    """Crop each labelled box, widened by 1.2 and 3 px, into a classification
    dataset `classification/{class}/{stem}_{j}.npy` beside `path`
    (reference :929-960)."""
    path = Path(path)
    out = path.parent / "classification"
    if out.exists():
        shutil.rmtree(out)
    n = 0
    for im_file in _frames(path):
        lb_file = Path(img2label_paths([str(im_file)])[0])
        if not lb_file.exists():
            continue
        im = np.load(im_file)
        h, w = im.shape[:2]
        with open(lb_file) as f:
            lb = np.array([x.split() for x in f.read().strip().splitlines()], dtype=np.float32)
        for j, x in enumerate(lb):
            c = int(x[0])
            f_out = out / str(c) / f"{im_file.stem}_{j}.npy"
            f_out.parent.mkdir(parents=True, exist_ok=True)
            b = x[1:5] * np.array([w, h, w, h])
            b[2:] = b[2:] * 1.2 + 3  # pad
            x1 = int(max(b[0] - b[2] / 2, 0))
            y1 = int(max(b[1] - b[3] / 2, 0))
            x2 = int(min(b[0] + b[2] / 2, w))
            y2 = int(min(b[1] + b[3] / 2, h))
            if x2 > x1 and y2 > y1:
                np.save(f_out, np.ascontiguousarray(im[y1:y2, x1:x2]))
                n += 1
    LOGGER.info(f"extract_boxes: wrote {n} crops to {out}")
    return out


def autosplit(path, weights=(0.9, 0.1, 0.0), annotated_only: bool = False, seed: int = 0):
    """Write autosplit_{train,val,test}.txt beside `path`, each frame drawn
    into one list by `weights` from Python's generator seeded with `seed`
    (reference :963-986)."""
    path = Path(path)
    files = sorted(_frames(path))
    rng = random.Random(seed)
    idx = rng.choices([0, 1, 2], weights=weights, k=len(files))
    txt = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for t in txt:
        (path.parent / t).unlink(missing_ok=True)
    n = 0
    for i, img in zip(idx, files):
        if annotated_only and not Path(img2label_paths([str(img)])[0]).exists():
            continue
        with open(path.parent / txt[i], "a") as f:
            f.write(f"./{img.relative_to(path.parent)}\n")
        n += 1
    LOGGER.info(f"autosplit: {n} images -> {txt}")
    return [path.parent / t for t in txt]


def dataset_stats(path, imgsz: int = 640, task: str = "detect") -> dict:
    """HUBDatasetStats-style summary: the frame count, the instances, the
    instances of each class (reference :1041-1160)."""
    ds = YoloDataset(path, imgsz=imgsz, task=task)
    counts = {}
    total = 0
    for lb in ds.labels:
        for c in lb[:, 0].astype(int):
            counts[int(c)] = counts.get(int(c), 0) + 1
            total += 1
    stats = {"images": len(ds), "instances": total, "per_class": dict(sorted(counts.items())),
             "imgsz": imgsz}
    LOGGER.info(json.dumps(stats, indent=2))
    return stats


CAMVID_NAMES = ["sky", "building", "pole", "road", "pavement", "tree",
                "signsymbol", "fence", "car", "pedestrian", "bicyclist",
                "unlabelled"]


def synthetic_camvid_arrays(n: int = 24, size: int = 96, seed: int = 11):
    """Deterministic 3-class CamVid-style scenes: sky band / road band / car
    rectangle (CamVid ids 0/3/8), colour-coded + noise so a learnable
    colour -> class mapping exists. Returns (imgs RGB uint8 (n, s, s, 3),
    masks uint8 (n, s, s))."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, size, size, 3), np.uint8)
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        horizon = rng.integers(size // 3, size // 2)
        img = np.zeros((size, size, 3), np.uint8)
        mask = np.full((size, size), 3, np.uint8)          # road
        img[:horizon] = (90, 140, 230)                      # sky: blue-ish
        mask[:horizon] = 0
        img[horizon:] = (95, 95, 95)                        # road: grey
        x, y = rng.integers(8, size - 40), rng.integers(horizon + 2, size - 24)
        w, h = rng.integers(18, 32), rng.integers(10, 18)
        img[y:y + h, x:x + w] = (200, 40, 40)               # car: red
        mask[y:y + h, x:x + w] = 8
        img = np.clip(img.astype(np.int16) + rng.integers(-18, 18, img.shape),
                      0, 255).astype(np.uint8)
        imgs[i], masks[i] = img, mask
    return imgs, masks


def write_synthetic_camvid_scene(root, n: int = 24, size: int = 96, seed: int = 11):
    """Write the synthetic scene as RGB `.npy` frames + per-frame JSON dense
    masks (the reference's JSON mask format; JAX names each record's frame
    `{i:03d}.png`, and so does this copy). Returns (img_dir, json_dir)."""
    root = Path(root)
    img_dir, json_dir = root / "imgs", root / "jsons"
    img_dir.mkdir(parents=True)
    json_dir.mkdir(parents=True)
    imgs, masks = synthetic_camvid_arrays(n, size, seed)
    for i in range(n):
        np.save(img_dir / f"{i:03d}.npy", imgs[i])
        payload = {"filename": f"{i:03d}.png", "shape": [size, size],
                   "dtype": "uint8", "class_names": CAMVID_NAMES,
                   "mask_data": masks[i].flatten().astype(int).tolist()}
        (json_dir / f"{i:03d}.json").write_text(json.dumps(payload))
    return img_dir, json_dir
