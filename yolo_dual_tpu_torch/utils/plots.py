"""Box and mask drawing for saved predictions, per-detection crops and
feature maps, the semantic path's CamVid colouring and panels, and the
training and validation plots: PR and metric curves, batch mosaics, results
and evolution grids, the speed study, label statistics, classification
mosaics and the LR schedule (port of yolo_dual_tpu/utils/plots.py;
reference utils/plots.py, utils/segment/plots.py). cv2 is imported only when
something is drawn with it, matplotlib only by the plots that need it: those
raise ImportError without it, and their callers log the skip where JAX's do.
Without cv2 a crop and a feature map are saved as `.npy` arrays."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


class Colors:
    """Ultralytics-style color palette cycling per class id."""

    def __init__(self):
        hexs = ("FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
                "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
                "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7")
        self.palette = [tuple(int(h[i:i + 2], 16) for i in (0, 2, 4)) for h in hexs]
        self.n = len(self.palette)

    def __call__(self, i, bgr=False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


class Annotator:
    """Box / mask / label drawing on a numpy HWC uint8 image
    (reference utils/plots.py:71-183)."""

    def __init__(self, im, line_width=None):
        self.im = np.ascontiguousarray(im)
        self.lw = line_width or max(round(sum(im.shape[:2]) / 2 * 0.003), 2)

    def box_label(self, box, label="", color=(128, 128, 128), txt_color=(255, 255, 255)):
        import cv2
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        cv2.rectangle(self.im, p1, p2, color, thickness=self.lw, lineType=cv2.LINE_AA)
        if label:
            tf = max(self.lw - 1, 1)
            w, h = cv2.getTextSize(label, 0, fontScale=self.lw / 3, thickness=tf)[0]
            outside = p1[1] - h >= 3
            p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
            cv2.rectangle(self.im, p1, p2, color, -1, cv2.LINE_AA)
            cv2.putText(self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                        0, self.lw / 3, txt_color, thickness=tf, lineType=cv2.LINE_AA)

    def masks(self, masks, colors_list, alpha: float = 0.5):
        """Alpha-blend instance masks. masks: (n, h, w) bool/float at image res."""
        if len(masks) == 0:
            return
        masks = np.asarray(masks, np.float32)
        overlay = self.im.astype(np.float32)
        for m, c in zip(masks, colors_list):
            m3 = m[..., None]
            overlay = overlay * (1 - m3 * alpha) + m3 * alpha * np.asarray(c, np.float32)
        self.im = overlay.astype(np.uint8)

    def text(self, xy, text: str, color=(255, 255, 255)):
        """Plain text at xy (reference Annotator.text, utils/plots.py:150)."""
        import cv2
        cv2.putText(self.im, text, (int(xy[0]), int(xy[1])), cv2.FONT_HERSHEY_SIMPLEX,
                    max(self.lw / 4.0, 0.4), color, max(self.lw // 2, 1), cv2.LINE_AA)

    def result(self):
        return self.im


CAMVID_PALETTE = np.array([
    [128, 128, 128], [128, 0, 0], [192, 192, 128], [128, 64, 128], [60, 40, 222],
    [128, 128, 0], [192, 128, 128], [64, 64, 128], [64, 0, 128], [64, 64, 0],
    [0, 128, 192], [0, 0, 0]], np.uint8)


def colorize_semantic(mask: np.ndarray, palette: np.ndarray = CAMVID_PALETTE) -> np.ndarray:
    """Class-id mask (h, w) -> RGB uint8 (h, w, 3) in `palette`'s colours."""
    return palette[np.clip(mask, 0, len(palette) - 1)]


def legend_strip(names, palette: np.ndarray = CAMVID_PALETTE, height: int = 640,
                 width: int = 160) -> np.ndarray:
    """Vertical class legend (reference test.py:121-130): a colour swatch a
    row, as JAX draws it, and the class name beside it where cv2 is installed."""
    strip = np.full((height, width, 3), 255, np.uint8)
    n = max(len(names), 1)
    row_h = height // n
    sw = max(min(row_h - 6, 24), 4)
    try:
        import cv2
    except ImportError:
        cv2 = None
    for i, name in enumerate(names):
        y0 = i * row_h + (row_h - sw) // 2
        strip[max(y0, 0):y0 + sw + 1, 6:7 + sw] = palette[i % len(palette)]
        if cv2 is not None:
            cv2.putText(strip, str(name), (12 + sw, y0 + sw - max(sw // 4, 2)),
                        cv2.FONT_HERSHEY_SIMPLEX, max(row_h / 80.0, 0.3), (0, 0, 0), 1,
                        cv2.LINE_AA)
    return strip


def semantic_panel(image: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                   palette: np.ndarray = CAMVID_PALETTE, names=None) -> np.ndarray:
    """[input | GT | prediction | diff (green right, red wrong)] side by side,
    plus a legend strip when `names` is given (reference
    seg_diceloss_Resnet50.py:851-872, val_diceloss.py:122-143). `image`: uint8
    RGB or float in [0, 1]."""
    img = (image * 255).astype(np.uint8) if image.dtype != np.uint8 else image
    diff = np.where((gt != pred)[..., None], np.array([255, 0, 0], np.uint8),
                    np.array([0, 255, 0], np.uint8))
    panels = [img, colorize_semantic(gt, palette), colorize_semantic(pred, palette), diff]
    if names is not None:
        panels.append(legend_strip(names, palette, height=img.shape[0]))
    return np.concatenate(panels, axis=1)


def _importable(name: str) -> bool:
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def feature_visualization(x, module_type: str, stage: int, n: int = 32,
                          save_dir=Path("runs/features")):
    """The first `n` channel maps of a feature tensor x (1, c, h, w) (JAX
    utils/plots.py:300, which takes NHWC; reference utils/plots.py:184):
    `stage{stage}_{module_type}.png`, 8 panels a row, where matplotlib is
    installed, else the maps themselves, (min(n, c), h, w) float32, as
    `stage{stage}_{module_type}.npy`. Returns the file, or None for a
    tensor that is not 4-D."""
    x = x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    if x.ndim != 4:
        return None
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    blocks = x[0][:n]
    f = save_dir / f"stage{stage}_{module_type.split('.')[-1]}.png"
    if not _importable("matplotlib"):
        np.save(f.with_suffix(".npy"), blocks.astype(np.float32))
        return f.with_suffix(".npy")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    cols = 8
    rows = int(np.ceil(len(blocks) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.5, rows * 1.5), tight_layout=True)
    for ax, blk in zip(np.atleast_1d(axes).ravel(), blocks):
        ax.imshow(blk, cmap="viridis")
        ax.axis("off")
    fig.savefig(f, dpi=150)
    plt.close(fig)
    return f


def save_one_box(xyxy, im, file=Path("im.jpg"), gain: float = 1.02, pad: int = 10,
                 square: bool = False, BGR: bool = False, save: bool = True):
    """Crop a (gain-scaled, padded) box from an HWC image (JAX
    utils/plots.py:321; reference utils/plots.py:560). The crop keeps the
    channel order with BGR, else reverses it, as cv2 writes it. Saved with
    an incremented name: a `.jpg` through cv2 where it is installed, else
    the crop's pixels in RGB order as a `.npy`. Returns the crop."""
    from yolo_dual_tpu_torch.utils.general import increment_path
    b = np.asarray(xyxy, np.float32).reshape(4)
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    w, h = b[2] - b[0], b[3] - b[1]
    if square:
        w = h = max(w, h)
    w, h = w * gain + pad, h * gain + pad
    x1 = int(np.clip(cx - w / 2, 0, im.shape[1]))
    x2 = int(np.clip(cx + w / 2, 0, im.shape[1]))
    y1 = int(np.clip(cy - h / 2, 0, im.shape[0]))
    y2 = int(np.clip(cy + h / 2, 0, im.shape[0]))
    crop = im[y1:y2, x1:x2, :: (1 if BGR else -1)]
    if save and crop.size:
        file = Path(file)
        file.parent.mkdir(parents=True, exist_ok=True)
        if _importable("cv2"):
            import cv2
            cv2.imwrite(str(increment_path(file.with_suffix(".jpg"))), np.ascontiguousarray(crop))
        else:
            np.save(increment_path(file.with_suffix(".npy")), np.ascontiguousarray(crop[..., ::-1]))
    return crop


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _read_csv(path):
    """{stripped column name: float64 values} of a CSV with a header row (what
    JAX's plots read with pandas)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    names = [c.strip() for c in rows[0]]
    vals = np.array([[float(v) for v in r] for r in rows[1:] if r], np.float64).reshape(-1, len(names))
    return {n: vals[:, i] for i, n in enumerate(names)}


def plot_pr_curve(px, py, ap, save_dir="pr_curve.png", names=()):
    """Precision-recall curve of each class (at most 20 named) and their mean
    (reference utils/metrics.py:321)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if len(py) else np.zeros((len(px), 0))
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    if py.shape[1]:
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, save_dir="mc_curve.png", names=(), xlabel="Confidence", ylabel="Metric"):
    """A metric against confidence for each class and their mean
    (reference utils/metrics.py:342)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names[i]}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = np.asarray(py).mean(0) if len(py) else np.zeros_like(px)
    ax.plot(px, y, linewidth=3, color="blue", label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)


def plot_images(images, targets, paths=None, fname="images.jpg", names=None, max_size=1920,
                max_subplots=16):
    """Mosaic of images with boxes (reference utils/plots.py:245-330).
    images: (bs, h, w, 3) float 0-1; targets rows [img, cls, xywhn...]."""
    import cv2
    images = np.asarray(images)
    bs, h, w, _ = images.shape
    bs = min(bs, max_subplots)
    ns = int(np.ceil(bs ** 0.5))
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        y, x = (i // ns) * h, (i % ns) * w
        mosaic[y:y + h, x:x + w] = (images[i] * 255).astype(np.uint8)
        if targets is not None and len(targets):
            ti = targets[targets[:, 0] == i]
            for row in ti:
                cls = int(row[1])
                bx = row[2:6] * np.array([w, h, w, h])
                x1, y1 = int(x + bx[0] - bx[2] / 2), int(y + bx[1] - bx[3] / 2)
                x2, y2 = int(x + bx[0] + bx[2] / 2), int(y + bx[1] + bx[3] / 2)
                cv2.rectangle(mosaic, (x1, y1), (x2, y2), colors(cls, True), 2)
    if fname:
        cv2.imwrite(str(fname), mosaic[..., ::-1])
    return mosaic


def plot_images_and_masks(images, targets, masks, fname="train_batch.jpg", names=None):
    """Instance-seg mosaic (reference utils/segment/plots.py:17-108): boxes and
    the overlap-encoded masks blended at alpha 0.5."""
    import cv2
    images = np.asarray(images)
    out = plot_images(images, targets, fname=None)
    bs, h, w, _ = images.shape
    ns = int(np.ceil(min(bs, 16) ** 0.5))
    masks = np.asarray(masks)
    for i in range(min(bs, 16)):
        y, x = (i // ns) * h, (i % ns) * w
        if masks.ndim == 3 and masks.shape[0] == bs:  # overlap-encoded
            plane = masks[i]
            if plane.shape != (h, w):
                plane = cv2.resize(plane.astype(np.float32), (w, h), interpolation=cv2.INTER_NEAREST)
            for idx in range(1, int(plane.max()) + 1):
                m = (plane == idx).astype(np.float32)[..., None]
                color = np.asarray(colors(idx), np.float32)
                region = out[y:y + h, x:x + w].astype(np.float32)
                out[y:y + h, x:x + w] = (region * (1 - m * 0.5) + m * 0.5 * color).astype(np.uint8)
    if fname:
        cv2.imwrite(str(fname), out[..., ::-1])
    return out


def plot_results(csv_file="results.csv", save_dir="."):
    """Every column of results.csv against the epoch -> results.png
    (reference utils/plots.py:503)."""
    plt = _pyplot()
    df = _read_csv(csv_file)
    cols = [c for c in df if c != "epoch"]
    n = len(cols)
    fig, axes = plt.subplots(max(1, (n + 4) // 5), 5, figsize=(18, 8), tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    x = df["epoch"] if "epoch" in df else np.arange(len(df[cols[0]]))
    for ax, c in zip(axes, cols):
        ax.plot(x, df[c], marker=".")
        ax.set_title(c, fontsize=9)
    out = Path(save_dir) / "results.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_evolve(evolve_csv="evolve.csv"):
    """Scatter grid of fitness against each evolved hyperparameter, the best
    point marked -> evolve.png beside the CSV (reference utils/plots.py:476-500)."""
    plt = _pyplot()
    evolve_csv = Path(evolve_csv)
    df = _read_csv(evolve_csv)
    fit = df["fitness"]
    best = int(np.argmax(fit))
    keys = [c for c in df if c != "fitness"]
    n = len(keys)
    ncols = 5
    fig, axes = plt.subplots(max(1, -(-n // ncols)), ncols,
                             figsize=(12, 2.4 * max(1, -(-n // ncols))), tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for ax, k in zip(axes, keys):
        v = df[k]
        ax.scatter(v, fit, c=fit, cmap="viridis", alpha=0.7, s=12)
        ax.scatter(v[best], fit[best], marker="+", c="red", s=80)
        ax.set_title(f"{k} = {v[best]:.3g}", fontsize=8)
    for ax in axes[len(keys):]:
        ax.axis("off")
    out = evolve_csv.with_name("evolve.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_val_study(file="", dir=".", x=None):
    """Speed against box mAP from the study_*.txt files of `segment.val --task
    study` (reference utils/plots.py:356-399): rows of 8 metrics
    [P, R, mAP50, mAP] of boxes and masks and 3 times [pre, inf, post]; `x`
    the swept image sizes, written beside each point."""
    plt = _pyplot()
    save_dir = Path(file).parent if file else Path(dir)
    files = [Path(file)] if file else sorted(save_dir.glob("study*.txt"))
    fig, ax = plt.subplots(1, 1, figsize=(8, 4), tight_layout=True)
    for f in files:
        y = np.loadtxt(f, dtype=np.float32, ndmin=2).T
        if not y.size:
            continue
        j = int(y[3].argmax()) + 1  # stop at the peak box mAP (reference :374)
        ax.plot(y[9, :j], y[3, :j] * 100, ".-", linewidth=2, markersize=8,
                label=f.stem.replace("study_", ""))
        if x is not None:
            for xi, tx, ty in zip(list(x)[:j], y[9, :j], y[3, :j] * 100):
                ax.annotate(str(int(xi)), (tx, ty), textcoords="offset points",
                            xytext=(4, 4), fontsize=7, alpha=0.7)
    ax.set_xlabel("inference time (ms/img)")
    ax.set_ylabel("box mAP50-95")
    ax.grid(alpha=0.2)
    ax.legend(loc="lower right")
    out = save_dir / "study.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_labels(labels, names=(), save_dir=Path(".")):
    """Dataset-label panels -> labels.jpg: class histogram, box overlay, xy and
    wh densities (reference utils/plots.py:402-445, without the seaborn
    correlogram). labels: (n, 5) [cls, xywh normalized]."""
    plt = _pyplot()
    import cv2
    labels = np.asarray(labels, np.float64)
    if not labels.size:
        return None
    save_dir = Path(save_dir)
    c, b = labels[:, 0], labels[:, 1:5]
    nc = int(c.max()) + 1
    fig, ax = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    ax = ax.ravel()
    y = ax[0].hist(c, bins=np.linspace(0, nc, nc + 1) - 0.5, rwidth=0.8)
    for i in range(min(nc, len(y[2].patches))):
        y[2].patches[i].set_color([v / 255 for v in colors(i)])
    ax[0].set_ylabel("instances")
    if 0 < len(names) < 30:
        ax[0].set_xticks(range(len(names)))
        labels_txt = list(names.values()) if isinstance(names, dict) else list(names)
        ax[0].set_xticklabels(labels_txt, rotation=90, fontsize=9)
    else:
        ax[0].set_xlabel("classes")
    img = np.full((1000, 1000, 3), 255, np.uint8)  # the first 1000 boxes, centred
    for cls, (_, _, w, h) in zip(c[:1000], b[:1000]):
        x1 = int((0.5 - w / 2) * 1000)
        y1 = int((0.5 - h / 2) * 1000)
        x2 = int((0.5 + w / 2) * 1000)
        y2 = int((0.5 + h / 2) * 1000)
        cv2.rectangle(img, (x1, y1), (x2, y2), colors(int(cls)), 1)
    ax[1].imshow(img)
    ax[1].axis("off")
    ax[2].hist2d(b[:, 0], b[:, 1], bins=50, cmap="Blues")
    ax[2].set_xlabel("x")
    ax[2].set_ylabel("y")
    ax[3].hist2d(b[:, 2], b[:, 3], bins=50, cmap="Blues")
    ax[3].set_xlabel("width")
    ax[3].set_ylabel("height")
    out = save_dir / "labels.jpg"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def imshow_cls(ims, labels=None, pred=None, names=None, nmax: int = 25,
               f=Path("images.jpg")):
    """Classification image mosaic with true and predicted captions
    (reference utils/plots.py:447-474). ims: (n, h, w, 3) RGB uint8 or float."""
    plt = _pyplot()
    ims = np.asarray(ims)
    n = min(len(ims), nmax)
    m = int(np.ceil(n ** 0.5))
    fig, axes = plt.subplots(m, m, figsize=(m * 1.8, m * 1.8), tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for i in range(n):
        im = ims[i]
        if im.dtype != np.uint8:
            im = (im * 255).clip(0, 255).astype(np.uint8)
        axes[i].imshow(im)
        title = []
        if labels is not None:
            title.append(str(names[int(labels[i])] if names else int(labels[i])))
        if pred is not None:
            title.append(f"pred: {names[int(pred[i])] if names else int(pred[i])}")
        if title:
            axes[i].set_title(" | ".join(title), fontsize=7)
    for a in axes:
        a.axis("off")
    f = Path(f)
    f.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(f, dpi=160)
    plt.close(fig)
    return f


def plot_lr_scheduler(lr_fn, steps: int, save_dir=Path(".")):
    """The learning rate over `steps` steps -> LR.png (reference
    utils/plots.py:309-320); lr_fn: step -> lr, e.g.
    train/optim.py:build_lr_schedule's."""
    plt = _pyplot()
    xs = np.arange(steps)
    ys = [float(lr_fn(x)) for x in xs]
    fig, ax = plt.subplots(figsize=(6, 4), tight_layout=True)
    ax.plot(xs, ys)
    ax.set_xlabel("step")
    ax.set_ylabel("LR")
    ax.grid(alpha=0.2)
    out = Path(save_dir) / "LR.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out
