"""Hyperparameter evolution (port of yolo_dual_tpu/utils/evolve.py; reference
--evolve, segment/train.py's meta table and utils/general.py:1020-1057
print_mutation): genetic mutation of the hyp dict, parents drawn from the
fitness log evolve.csv."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from yolo_dual_tpu_torch.utils.general import LOGGER

# (mutation scale, lower, upper) per hyp: the reference's meta table
META = {
    "lr0": (1, 1e-5, 1e-1), "lrf": (1, 0.01, 1.0), "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001), "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95), "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2), "cls": (1, 0.2, 4.0), "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0), "obj_pw": (1, 0.5, 2.0), "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0), "hsv_h": (1, 0.0, 0.1), "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9), "degrees": (1, 0.0, 45.0), "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9), "shear": (1, 0.0, 10.0), "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0), "fliplr": (0, 0.0, 1.0), "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0), "copy_paste": (1, 0.0, 1.0),
}


def mutate(hyp: dict, evolve_csv, mp: float = 0.8, sigma: float = 0.2, seed=None) -> dict:
    """One genetic mutation: a parent drawn from the best 5 rows of evolve.csv
    by fitness, then a scaled gaussian mutation of each META key within its
    bounds, from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    evolve_csv = Path(evolve_csv)
    hyp = dict(hyp)
    if evolve_csv.exists():
        rows = np.loadtxt(evolve_csv, delimiter=",", skiprows=1, ndmin=2)
        if len(rows):
            n = min(5, len(rows))
            best = rows[np.argsort(-rows[:, 0])][:n]
            w = best[:, 0] - best[:, 0].min() + 1e-6
            parent = best[rng.choice(n, p=w / w.sum())]
            with open(evolve_csv) as f:
                keys = next(csv.reader(f))[1:]
            for k, v in zip(keys, parent[1:]):
                if k in hyp:
                    hyp[k] = float(v)
    for k, (scale, lo, hi) in META.items():
        if k in hyp and scale > 0:
            if rng.random() < mp:
                hyp[k] = float(np.clip(hyp[k] * (1 + rng.normal() * sigma * scale), lo, hi))
    return hyp


def print_mutation(keys, results, hyp: dict, save_dir, fitness_value: float):
    """Append a row [fitness, META keys of hyp] to save_dir/evolve.csv, with the
    header on a new file (reference utils/general.py:1020-1057)."""
    evolve_csv = Path(save_dir) / "evolve.csv"
    hyp_keys = [k for k in META if k in hyp]
    header = ["fitness"] + hyp_keys
    new = not evolve_csv.exists()
    with open(evolve_csv, "a", newline="") as f:
        wtr = csv.writer(f)
        if new:
            wtr.writerow(header)
        wtr.writerow([fitness_value] + [hyp[k] for k in hyp_keys])
    LOGGER.info(f"evolve: fitness {fitness_value:.4f} logged to {evolve_csv}")
    return evolve_csv
