"""Semantic-segmentation losses on NCHW scores: class-weighted CE + 0.5 x Dice
or Jaccard (port of yolo_dual_tpu/losses/semantic.py; reference
unet-lite/Resnet50/seg_diceloss_Resnet50.py:741-787, yolov8/seg_jaccardloss_yolov8.py:799-815).

The reference's quirks are kept, as JAX keeps them:
- `pred` is whatever the model emits: the semantic graphs end in
  nn.Softmax, yet the loss treats that output as logits (log_softmax for the
  CE, another softmax for Dice/Jaccard);
- CE is torch CrossEntropyLoss(weight, label_smoothing): per-pixel weighted
  NLL normalised by the sum of the target pixels' weights;
- Dice/Jaccard weight the prediction only, and average over (batch, class);
- no ignore_index in the loss (class 11 is ignored only in evaluation).

Inside parallel/mesh.py:across(mesh) a rank's loss is its share of the global
batch's: the CE's pixel weights and the Dice / Jaccard (image, class) terms
are counted over every rank, as JAX's jit over the sharded batch counts them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_dual_tpu_torch.parallel.mesh import global_sum, mean_share


def _one_hot(target: torch.Tensor, nc: int, dtype=torch.float32) -> torch.Tensor:
    """(b, h, w) class ids -> (b, nc, h, w) of `dtype`."""
    return F.one_hot(target.long(), nc).permute(0, 3, 1, 2).to(dtype)


def _at_least_f32(pred: torch.Tensor) -> torch.Tensor:
    """Scores in float32, or float64 where they are (bfloat16 ones are widened)."""
    return pred.to(torch.promote_types(pred.dtype, torch.float32))


def weighted_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                           class_weights: torch.Tensor, label_smoothing: float = 0.0):
    """torch F.cross_entropy(weight=w, label_smoothing=s) on (b, nc, h, w)
    scores, normalised by the sum of the target pixels' weights."""
    nc = pred.shape[1]
    logp = torch.log_softmax(_at_least_f32(pred), dim=1)
    target = target.long()
    pix_w = class_weights[target]                                            # (b, h, w)
    main = -logp.gather(1, target[:, None])[:, 0] * pix_w
    smooth = -(logp * class_weights[None, :, None, None]).sum(1)
    s = label_smoothing
    nll = (1.0 - s) * main + (s / nc) * smooth
    return nll.sum() / (global_sum(pix_w.sum()) + 1e-12)


def _overlaps(pred_prob, target, class_weights):
    """(intersection, prediction sum, target sum), each (b, nc), of the
    class-weighted prediction and the one-hot target."""
    onehot = _one_hot(target, pred_prob.shape[1], pred_prob.dtype)
    wpred = pred_prob * class_weights[None, :, None, None]
    return (wpred * onehot).sum((2, 3)), wpred.sum((2, 3)), onehot.sum((2, 3))


def dice_loss(pred_prob: torch.Tensor, target: torch.Tensor, class_weights: torch.Tensor,
              eps: float = 1e-6):
    """1 - mean Dice over (batch, class), the prediction weighted by class."""
    inter, psum, tsum = _overlaps(pred_prob, target, class_weights)
    return mean_share(1.0 - (2.0 * inter + eps) / (psum + tsum + eps))


def jaccard_loss(pred_prob: torch.Tensor, target: torch.Tensor, class_weights: torch.Tensor,
                 eps: float = 1e-6):
    """1 - mean IoU over (batch, class), the prediction weighted by class."""
    inter, psum, tsum = _overlaps(pred_prob, target, class_weights)
    return mean_share(1.0 - (inter + eps) / (psum + tsum - inter + eps))


class SemanticSegLoss:
    """total = CE + 0.5 x (Dice | Jaccard), or CE alone (flavor "ce").

    pred: (b, nc, h, w) model output (treated as logits); target: (b, h, w)
    class ids, nearest-resized (half-pixel) to pred's size where it differs.
    Returns (total, (total, ce, aux))."""

    def __init__(self, nc: int = 12, label_smoothing: float = 0.0,
                 class_weights: Optional[Sequence[float]] = None, flavor: str = "dice"):
        if flavor not in ("dice", "jaccard", "ce"):
            raise ValueError(f"flavor {flavor!r}: expected 'dice', 'jaccard' or 'ce'")
        self.nc = nc
        self.label_smoothing = float(label_smoothing)
        w = np.ones(nc, np.float32) if class_weights is None else np.asarray(class_weights, np.float32)
        self.class_weights = torch.from_numpy(w)
        self.flavor = flavor

    def __call__(self, pred: torch.Tensor, target: torch.Tensor):
        w = self.class_weights.to(pred.device)
        if pred.shape[-2:] != target.shape[-2:]:
            target = F.interpolate(target[:, None].float(), size=tuple(pred.shape[-2:]),
                                   mode="nearest-exact")[:, 0].long()
        ce = weighted_cross_entropy(pred, target, w, self.label_smoothing)
        if self.flavor == "ce":
            aux = torch.zeros((), device=pred.device)
            total = ce
        else:
            prob = torch.softmax(_at_least_f32(pred), dim=1)
            fn = dice_loss if self.flavor == "dice" else jaccard_loss
            aux = fn(prob, target, w)
            total = ce + 0.5 * aux
        return total, (total, ce, aux)


def seg_labels_to_class_weights(json_files, num_classes: int) -> np.ndarray:
    """Class weights total / (nc x count) over the JSON masks' pixels; an
    unreadable file is skipped (reference seg_diceloss_Resnet50.py:791-809)."""
    counts = np.zeros(num_classes, np.int64)
    total = 0
    for f in json_files:
        try:
            flat = np.asarray(json.loads(Path(f).read_text())["mask_data"], np.int64)
        except (OSError, ValueError, KeyError):
            continue
        counts += np.bincount(flat, minlength=num_classes)[:num_classes]
        total += flat.size
    return (total / (num_classes * (counts + 1e-8))).astype(np.float32)


def parse_class_weights(spec, num_classes: int, class_names: Optional[Sequence[str]] = None):
    """Class weights from a sequence, a CSV string, or a file holding a
    {name: weight} mapping or a list: JSON always, YAML where PyYAML is
    installed. None or empty -> None (reference seg_diceloss_Resnet50.py:812-847)."""
    if spec is None or (not isinstance(spec, (list, tuple, np.ndarray)) and not spec):
        return None
    if isinstance(spec, (list, tuple, np.ndarray)):
        w = list(spec)
    elif Path(str(spec)).exists():
        text = Path(str(spec)).read_text()
        if Path(str(spec)).suffix == ".json":
            data = json.loads(text)
        else:
            try:
                import yaml
            except ImportError as e:
                raise ImportError(f"{spec} is YAML but PyYAML is not installed; give the "
                                  "weights as JSON or a CSV string") from e
            data = yaml.safe_load(text)
        if isinstance(data, dict):
            w = list(data.values()) if class_names is None else \
                [data[c] for c in class_names[:num_classes]]
        elif isinstance(data, list):
            w = data
        else:
            raise ValueError("weight file must contain a dict or list")
    else:
        w = [float(x) for x in str(spec).split(",")]
    if len(w) != num_classes:
        raise ValueError(f"{len(w)} weights for {num_classes} classes")
    return np.asarray(w, np.float32)
