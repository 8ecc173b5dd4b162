"""Training engine: one train step (forward, loss, backward, optimizer, EMA),
the eval step and early stopping (port of yolo_dual_tpu/train/trainer.py;
reference segment/train.py:348-589, seg_diceloss_Resnet50.py:875-1215), for
the detect, segment, semantic and classify tasks, and `classify_loss`.

A batch is a dict in the format the JAX package's loader yields. Detect and
segment: `image` (bs, H, W, 3) uint8 or float, `targets` (bs, M, 5)
normalised [cls, x, y, w, h], `tmask` (bs, M) bool, and for segment `masks`
((bs, h, w) overlap-indexed, or (bs, M, h, w)). Semantic: `mask` (bs, H, W)
class ids and `image` either uint8 (bs, H, W, 3) (the host route) or
float32 (bs, 3, H, W) in [0, 1], as kernels/preprocess.py:semantic_preprocess
returns it (the device route). Classify: `image` (bs, H, W, 3) float32,
ImageNet-normalised (data/classify.py), and `label` (bs,) class ids. Arrays
or tensors on any device; they are moved to the model's.

`remat` (--remat) recomputes the forward in the backward instead of keeping
its activations (torch.utils.checkpoint; JAX's jax.checkpoint): the
recomputed forward normalises by the same batch statistics and leaves the
BatchNorm running statistics alone, so a step updates them once, as without
remat. On yolov5s-seg-dcnv3 the DCNv3 forward kernel then launches twice a
micro-step for each of its 6 calls and the backward once. Under a mesh the
recompute sits inside DistributedDataParallel (`Rematerialised`), so the
backward reruns the model's forward and never DDP's. `dropout` gives
each micro-step its own seeded generator for the heads' dropout (JAX folds
the step into PRNGKey(17); the streams differ).

`mesh` (parallel/mesh.py:make_mesh, one process a rank) trains data-parallel
as JAX's Trainer(mesh=...) does on a batch sharded over its devices: each
rank's batch is its rows of the global batch, every BatchNorm takes its
statistics over the global batch (convert_sync_batchnorm), the loss is the
rank's share of the global-batch loss (the losses under parallel/mesh.py:across),
and DistributedDataParallel averages W · share's gradients, which gives
the global loss's gradient on every rank. The optimizer and the EMA then
take the same steps on every rank. DDP runs with find_unused_parameters:
some graphs hold layers that feed no output (yolov5_seg's head rows 12-20,
ROADMAP §C); their gradients stay None, which the optimizer reads as zeros,
as JAX's gradient of them is zero. The BatchNorm buffers are not broadcast
at each forward: the synchronised statistics are the same on every rank.

A 2-D `mesh` (parallel/mesh.py:make_mesh_2d, dp x sp ranks) trains as JAX's
Trainer(mesh=make_mesh_2d(dp, sp)) does (JAX train/trainer.py:170-187): each
rank's batch is its data shard's rows, `image` cut to its band of rows
(parallel/mesh.py:shard_batch), the targets and mask planes whole. The model
runs on the bands (parallel/spatial.py:spatial; models/model.py:_walk) and
its head's outputs come back whole on every space rank, so each space rank
computes its data shard's loss share whole; the losses' normalisers reduce
over the data group alone, and BatchNorm over the world, where the bands
partition the global batch's pixels. Gradient rule: a rank's parameter
gradients are its band's share of its data shard's loss share's, so the
gradient of the global loss is their sum over space and over data; DDP over
the world averages W · share's gradients with W = dp · sp (`Mesh.world`), which
gives that sum on every rank (the 1-D rule with sp = 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.nn.common import frozen_batch_stats
from yolo_dual_tpu_torch.parallel import spatial
from yolo_dual_tpu_torch.parallel.mesh import across, convert_sync_batchnorm, global_sum, mean_share
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


DROPOUT_SEED = 17  # the dropout generator of micro-step t is seeded (17 << 32) + t


class Rematerialised(nn.Module):
    """`model` whose activations are recomputed in the backward; the recompute
    leaves the BatchNorm running statistics alone. Under a mesh DDP wraps
    this module, so the recompute runs the model and not DDP's forward, which
    would prepare DDP's reducer a second time in the middle of its
    reduction."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, **kw):
        # the recompute runs in the backward, which may run outside the step's `spatial`
        mesh = spatial.space_mesh()

        @contextlib.contextmanager
        def recompute():
            with frozen_batch_stats(self.model), spatial.spatial(mesh):
                yield
        return checkpoint(lambda t: self.model(t, **kw), x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), recompute()))


@dataclasses.dataclass
class Trainer:
    """Train and eval steps of a Detect or Segment model. The optimizer
    accumulates gradients itself (see SmartOptimizer), so a train step is one
    micro-step, and the EMA advances only on the optimizer's real steps."""

    model: nn.Module
    loss_fn: Any                     # ComputeLoss (detect) or ComputeSegmentLoss (segment)
    optimizer: SmartOptimizer
    ema: Optional[ModelEMA] = None
    task: str = "segment"            # detect | segment | semantic | classify
    amp_dtype: Optional[torch.dtype] = None  # torch.bfloat16: forward and loss under autocast
    remat: bool = False              # recompute the forward in the backward; read at construction
    dropout: bool = False            # a seeded generator a micro-step for the heads' dropout
    mesh: Any = None                 # parallel/mesh.py:Mesh: data (x space) parallel over its ranks

    def __post_init__(self):
        if self.task not in ("detect", "segment", "semantic", "classify"):
            raise ValueError(f"task {self.task!r}: the port trains detect, segment, "
                             "semantic and classify models")
        # the module a train step runs: the model, rematerialised with `remat`,
        # under DDP with a mesh
        self.net = Rematerialised(self.model) if self.remat else self.model
        self.ddp = None
        if self.mesh is not None and self.mesh.world > 1:
            from torch.nn.parallel import DistributedDataParallel
            convert_sync_batchnorm(self.model, self.mesh)
            dev = next(self.model.parameters()).device
            self.ddp = DistributedDataParallel(
                self.net, device_ids=[dev] if dev.type == "cuda" else None,
                find_unused_parameters=True, broadcast_buffers=False)

    def init_state(self) -> TrainState:
        return TrainState(self.model, self.optimizer, self.ema)

    def model_input(self, image: torch.Tensor) -> torch.Tensor:
        """The model's NCHW float input: uint8 (bs, H, W, 3) is scaled to [0, 1]
        and moved to NCHW; a float semantic batch is semantic_preprocess's
        NCHW output in [0, 1] and is taken as it is; a float detect or
        segment batch is NHWC."""
        if self.task == "semantic" and image.dtype != torch.uint8:
            return image.contiguous()
        return normalize_image(image).permute(0, 3, 1, 2).contiguous()

    def forward_loss(self, model: nn.Module, batch: Dict[str, Any]):
        """Train-mode forward of the normalised NCHW batch and the task loss:
        (loss · bs, loss items) for detect and segment, (loss, (total, ce,
        aux)) for semantic and (loss, (loss, acc)) for classify, whose losses
        are means (JAX trainer.py:107-114; the
        model's scores already come at the input's size). With `amp_dtype` both
        run under torch.autocast (the JAX model's bf16 compute dtype:
        convolutions and matmuls in bfloat16, parameters, BatchNorm statistics
        and the DCNv3 sampling in float32); the loss and its items then come
        back in float32."""
        dev = next(model.parameters()).device
        b = _on(batch, dev)
        x = self.model_input(b["image"])
        kw = {} if self.task in ("semantic", "classify") else {"decode": False}
        with torch.autocast(dev.type, dtype=self.amp_dtype or torch.float32,
                            enabled=self.amp_dtype is not None):
            out = model(x, **kw)
            if self.task == "semantic":
                loss, items = self.loss_fn(out, b["mask"])
                items = torch.stack(items).detach()
            elif self.task == "classify":
                loss, items = self.loss_fn(out, b["label"])
                items = torch.stack(items).detach()
            elif self.task == "segment":
                loss, items = self.loss_fn(out, b["targets"], b["tmask"], b["masks"])
            else:
                loss, items = self.loss_fn(out, b["targets"], b["tmask"])
        if self.amp_dtype is not None:
            loss, items = loss.float(), items.float()
        return loss, items

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
        (state, {"loss": the loss (· bs for detect and segment), "items": loss
        items})."""
        state.model.train()
        state.model.zero_grad(set_to_none=True)
        # this rank's share of the global loss; DDP averages W · share's gradients
        # (without a mesh: the loss itself, W = 1, and the sums are the values)
        model, w = (self.net, 1) if self.ddp is None else (self.ddp, self.mesh.world)
        with self.dropout_rng(state), across(self.mesh), spatial.spatial(self.mesh):
            loss, items = self.forward_loss(model, batch)
            (loss * w).backward()
            loss, items = global_sum(loss.detach()), global_sum(items)
        self.apply_gradients(state)
        return state, {"loss": loss.detach(), "items": items}

    @contextlib.contextmanager
    def dropout_rng(self, state: TrainState):
        """With `dropout`, torch's generators seeded for this micro-step inside
        (restored after); else nothing."""
        if not self.dropout:
            yield
            return
        dev = next(state.model.parameters()).device
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed((DROPOUT_SEED << 32) + state.step)
            yield

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, Any]):
        """Eval-mode output of the EMA model (of the model without an EMA):
        decoded detections, the semantic scores, or the class logits."""
        model = (state.ema.ema if state.ema is not None else state.model).eval()
        b = _on({"image": batch["image"]}, next(model.parameters()).device)
        return model(self.model_input(b["image"]))


def classify_loss(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0):
    """Softmax cross-entropy against one-hot labels smoothed by
    `label_smoothing` (eps/nc added to every class), the batch mean (JAX
    train/trainer.py:211; reference classify/train.py). Returns (loss,
    (loss, top-1 accuracy))."""
    nc = logits.shape[-1]
    target = F.one_hot(labels.long(), nc).to(logits.dtype)
    if label_smoothing:
        target = target * (1 - label_smoothing) + label_smoothing / nc
    loss = mean_share(-(target * F.log_softmax(logits, -1)).sum(-1))
    acc = mean_share((logits.argmax(-1) == labels).to(logits.dtype))
    return loss, (loss, acc)
