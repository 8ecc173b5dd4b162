"""Several weights files behind one forward (port of
yolo_dual_tpu/io/ensemble.py; reference models/experimental.py:71-111
attempt_load and its Ensemble).

    ens = attempt_load(["a.pt", "runs/train-seg/exp/best"], "yolov5s-seg.json")
    pred, protos = ens(x)       # x: (b, 3, h, w) float in [0, 1], on cuda
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import torch

from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import GraphModel, SegmentationModel
from yolo_dual_tpu_torch.utils.general import LOGGER, select_device

MODES = ("cat", "mean")


class Ensemble:
    """Members of one graph, each with its own weights; a forward runs them
    all in eval mode and merges their decoded predictions.

    mode="cat"  concatenates them along the candidate axis (the reference
                Ensemble's default, experimental.py:39: NMS removes the
                duplicates);
    mode="mean" averages them elementwise (the members share the graph, so
                the shapes agree).
    Protos come from the first member: under "cat" each row keeps its own
    member's mask coefficients against member 0's protos, the caveat the
    torch ensemble has too."""

    def __init__(self, models: Sequence[GraphModel], mode: str = "cat"):
        if mode not in MODES:
            raise ValueError(f"Ensemble mode {mode!r}: expected one of {MODES}")
        if not models:
            raise ValueError("an Ensemble needs at least one member")
        self.models = [m.eval() for m in models]
        self.mode = mode
        first = self.models[0]
        self.nc, self.names = first.nc, first.names
        self.stride = list(first.spec.strides)

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor):
        """(b, 3, h, w) float in [0, 1] -> (merged predictions, protos | None)."""
        preds, protos = [], None
        for m in self.models:
            out = m(x)
            if isinstance(out, tuple) and len(out) == 3:  # Segment: (pred, protos, raw)
                p, pr, _ = out
                protos = pr if protos is None else protos
            else:
                p = out[0] if isinstance(out, tuple) else out
            preds.append(p)
        merged = torch.cat(preds, 1) if self.mode == "cat" else sum(preds) / len(preds)
        return merged, protos

    forward = __call__


def attempt_load(weights, cfg, nc: int = 80, mode: str = "cat", device="cuda"):
    """Load one or several weights (reference attempt_load,
    models/experimental.py:71-111): `.pt` files or orbax checkpoint
    directories of the JAX package, each into a SegmentationModel of `cfg`
    on `device`. One path returns (model, its state_dict); several return an
    Ensemble."""
    ws = [weights] if isinstance(weights, (str, Path)) else list(weights)
    dev = select_device(device)
    models, sds = [], []
    for w in ws:
        model = SegmentationModel(cfg, nc=nc, device=dev)
        sd = resolve_state_dict(w, model)
        model.load_state_dict(sd, strict=True)
        models.append(model.eval())
        sds.append(sd)
    if len(ws) == 1:
        return models[0], sds[0]
    LOGGER.info(f"Ensemble created with {len(ws)} models ({mode} merge)")
    return Ensemble(models, mode=mode)
