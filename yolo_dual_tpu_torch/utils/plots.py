"""Box and mask drawing for saved predictions, per-detection crops and
feature maps, and the semantic path's CamVid colouring and panels (port of
the parts of yolo_dual_tpu/utils/plots.py that the predictors and the
semantic val CLI use). cv2 is imported only when a box or a legend's text is
drawn or a crop written; matplotlib only when a feature map is drawn.
Without them a crop and a feature map are saved as `.npy` arrays."""

from __future__ import annotations

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
