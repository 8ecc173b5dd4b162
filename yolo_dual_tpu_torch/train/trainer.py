"""Training engine: one train step (forward, loss, backward, optimizer, EMA),
the eval step and early stopping (port of yolo_dual_tpu/train/trainer.py;
reference segment/train.py:348-589), for the detect and segment tasks.

A batch is a dict in the format the JAX package's loader yields: `image`
(bs, H, W, 3) uint8 or float, `targets` (bs, M, 5) normalised [cls, x, y, w, h],
`tmask` (bs, M) bool, and for segment `masks` ((bs, h, w) overlap-indexed, or
(bs, M, h, w)). Arrays or tensors on any device; they are moved to the model's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import SmartOptimizer
from yolo_dual_tpu_torch.utils.general import LOGGER


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState's counterpart: the model holds the parameters and
    BatchNorm statistics, the optimizer its own state, `ema` the EMA model and
    its update count; `step` counts micro-steps."""
    model: nn.Module
    optimizer: SmartOptimizer
    ema: Optional[ModelEMA] = None
    step: int = 0


class EarlyStopping:
    """Stop after `patience` epochs without fitness improvement
    (reference utils/torch_utils.py:381-401)."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")
        self.possible_stop = False

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        delta = epoch - self.best_epoch
        self.possible_stop = delta >= (self.patience - 1)
        stop = delta >= self.patience
        if stop:
            LOGGER.info(f"Stopping early: no improvement in last {self.patience} epochs "
                        f"(best epoch {self.best_epoch}).")
        return stop


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


@dataclasses.dataclass
class Trainer:
    """Train and eval steps of a Detect or Segment model. The optimizer
    accumulates gradients itself (see SmartOptimizer), so a train step is one
    micro-step, and the EMA advances only on the optimizer's real steps."""

    model: nn.Module
    loss_fn: Any                     # ComputeLoss (detect) or ComputeSegmentLoss (segment)
    optimizer: SmartOptimizer
    ema: Optional[ModelEMA] = None
    task: str = "segment"            # detect | segment

    def __post_init__(self):
        if self.task not in ("detect", "segment"):
            raise ValueError(f"task {self.task!r}: the port trains detect and segment models")

    def init_state(self) -> TrainState:
        return TrainState(self.model, self.optimizer, self.ema)

    def forward_loss(self, model: nn.Module, batch: Dict[str, Any]):
        """Train-mode forward of the normalised NCHW batch and the task loss:
        (loss · bs, loss items)."""
        b = _on(batch, next(model.parameters()).device)
        x = normalize_image(b["image"]).permute(0, 3, 1, 2).contiguous()
        out = model(x, decode=False)
        if self.task == "segment":
            return self.loss_fn(out, b["targets"], b["tmask"], b["masks"])
        return self.loss_fn(out, b["targets"], b["tmask"])

    def apply_gradients(self, state: TrainState) -> bool:
        """The optimizer's micro-step on the parameters' gradients, then the EMA
        if the optimizer applied an update. True on a real step."""
        stepped = state.optimizer.step()
        if stepped and state.ema is not None:
            state.ema.update(state.model)
        state.step += 1
        return stepped

    def train_step(self, state: TrainState, batch: Dict[str, Any]):
        """One micro-step: forward, loss, backward, optimizer, EMA. The
        parameters keep this step's gradients in `.grad` afterwards. Returns
        (state, {"loss": loss · bs, "items": loss items})."""
        state.model.train()
        state.model.zero_grad(set_to_none=True)
        loss, items = self.forward_loss(state.model, batch)
        loss.backward()
        self.apply_gradients(state)
        return state, {"loss": loss.detach(), "items": items}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, Any]):
        """Decoded eval-mode output of the EMA model (of the model without an EMA)."""
        model = (state.ema.ema if state.ema is not None else state.model).eval()
        b = _on({"image": batch["image"]}, next(model.parameters()).device)
        return model(normalize_image(b["image"]).permute(0, 3, 1, 2).contiguous())
