"""Synthetic CamVid-style scene (port of yolo_dual_tpu/data/tools.py:118-163,
the data of tests/test_semantic_golden.py's learning goldens).

The arrays equal JAX's; the scene is written with `.npy` frames, where JAX
writes PNG through cv2 (the card's machine has no cv2), beside the same JSON
dense masks.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

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
