"""AutoAnchor: the anchors' fit to the labels and their k-means and genetic
evolution (port of yolo_dual_tpu/utils/autoanchor.py; reference
utils/autoanchor.py:17-169). Host numpy and scipy: under the same seeds the
answers are JAX's bit for bit."""

from __future__ import annotations

import numpy as np

from yolo_dual_tpu_torch.utils.general import LOGGER

PREFIX = "AutoAnchor: "


def _metric(k, wh):
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1 / r).min(2)
    best = x.max(1)
    return x, best


def anchor_fitness(k, wh, thr):
    _, best = _metric(k, wh)
    return (best * (best > thr)).mean()


def check_anchors(dataset_shapes, dataset_labels, anchors, stride, thr: float = 4.0,
                  imgsz: int = 640):
    """BPR check; returns (bpr, suggested_anchors|None)
    (reference utils/autoanchor.py:17-55).

    dataset_shapes: (n, 2) original (h, w) — the YoloDataset cache layout;
    dataset_labels: list of (m, 5) [cls, xywh normalized]; anchors: (nl, na, 2)
    PIXEL anchors (the config convention — the head divides by stride itself),
    so `stride` is accepted only for reference-signature parity and performs
    no rescale here."""
    shapes = imgsz * np.asarray(dataset_shapes, np.float64) \
        / np.asarray(dataset_shapes).max(1, keepdims=True)
    scale = np.random.uniform(0.9, 1.1, size=(len(shapes), 1))
    # labels store (w, h) normalized; shapes rows are (h, w) -> flip before
    # the per-axis pixel scale or every box's aspect inverts on non-square
    # images (advisor r2)
    wh = np.concatenate([l[:, 3:5] * s[::-1] * sc for s, sc, l in
                         zip(shapes, scale, dataset_labels) if len(l)])
    k = np.asarray(anchors, np.float32).reshape(-1, 2)
    x, best = _metric(k, wh)
    aat = (x > 1 / thr).sum(1).mean()
    bpr = (best > 1 / thr).mean()
    LOGGER.info(f"{PREFIX}{aat:.2f} anchors/target, {bpr:.3f} Best Possible Recall (BPR)")
    if bpr > 0.98:
        return bpr, None
    LOGGER.info(f"{PREFIX}BPR < 0.98; attempting to improve anchors...")
    na = k.shape[0]
    new_k = kmean_anchors(wh, n=na, thr=thr)
    if anchor_fitness(new_k, wh, 1 / thr) > anchor_fitness(k, wh, 1 / thr):
        return bpr, new_k.reshape(np.asarray(anchors).shape)
    LOGGER.info(f"{PREFIX}original anchors better; keeping")
    return bpr, None


def kmean_anchors(wh: np.ndarray, n: int = 9, thr: float = 4.0, gen: int = 1000,
                  verbose: bool = False, seed: int = 0) -> np.ndarray:
    """k-means on wh + genetic evolution of anchor fitness
    (reference utils/autoanchor.py:58-169)."""
    from scipy.cluster.vq import kmeans
    thr = 1 / thr
    rng = np.random.default_rng(seed)
    wh = wh[(wh >= 2.0).any(1)]
    s = wh.std(0)
    try:
        k, _ = kmeans(wh / s, n, iter=30, seed=seed)
        assert n == len(k)
    except Exception:
        k = np.sort(rng.random((n, 2))) * wh.max(0)[None] / 2
        s = np.ones(2)
    k = k * s
    k = k[np.argsort(k.prod(1))]

    f = anchor_fitness(k, wh, thr)
    sh = k.shape
    mp, sigma = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random() * rng.standard_normal(sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    LOGGER.info(f"{PREFIX}evolved anchors: fitness={f:.4f}")
    return k
