"""Optimizer: three parameter groups, warmup-aware schedules and gradient
accumulation (port of yolo_dual_tpu/train/optim.py; reference
utils/torch_utils.py:318-346 smart_optimizer and the warmup of
segment/train.py:521-529).

Groups: g0 = weights, with weight decay; g1 = BatchNorm and LayerNorm
weights, no decay;
g2 = biases, no decay, whose warmup starts at `warmup_bias_lr`. The update is
the math of the JAX package's fused optimizer (`_fused_smart_optimizer`):
SGD with Nesterov momentum, Adam/AdamW with decoupled decay, RMSProp. The
schedules are evaluated in float32 at the inner step count before it is
incremented, times `accumulate`, as there.
"""

from __future__ import annotations

import math
from typing import Callable, Collection, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from yolo_dual_tpu_torch.utils.general import LOGGER

f32 = np.float32


def batchnorm_weights(model: nn.Module) -> set:
    """The names of the weights of `model`'s normalisation layers, whatever
    the layers are called (a Conv's `bn`, a bare BatchNorm row, ConvNeXt's
    `ln`): the torch side of JAX's `scale` leaves, BatchNorm's and
    LayerNorm's alike."""
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm))
            and m.weight is not None}


def param_group_label(name: str, bn_weights: Optional[Collection[str]] = None) -> str:
    """g0: weights with decay; g1: normalisation weights; g2: biases (JAX
    optim.py:26: `bias` -> g2, any `scale` -> g1, the rest g0, ConvNeXt's
    layer scale `gamma` among them). The normalisation weights are
    `bn_weights` where given (batchnorm_weights of the model), else the
    weights of modules named `bn` (`model.2.cv1.bn.weight`)."""
    parts = name.split(".")
    if parts[-1] == "bias":
        return "g2"
    if bn_weights is None:
        is_bn = parts[-1] == "weight" and "bn" in parts[:-1]
    else:
        is_bn = name in bn_weights
    return "g1" if is_bn else "g0"


def one_cycle(y1: float, y2: float, steps: int) -> Callable[[float], float]:
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def _lf(e, epochs, lrf, cos_lr):
    if cos_lr:
        return ((f32(1) - np.cos(f32(e * f32(math.pi)) / f32(epochs))) / f32(2)) \
            * f32(lrf - 1.0) + f32(1)
    return (f32(1) - e / f32(epochs)) * f32(1.0 - lrf) + f32(lrf)


def _warmup_iters(hyp: Dict, steps_per_epoch: int) -> int:
    return max(round(hyp.get("warmup_epochs", 3.0) * steps_per_epoch), 100)


def build_lr_schedule(hyp: Dict, epochs: int, steps_per_epoch: int, cos_lr: bool = False,
                      group: str = "g0", accumulate: int = 1) -> Callable[[int], float]:
    """Learning rate at inner step `step`: the epoch decay (linear, or
    one_cycle with `cos_lr`) evaluated at whole epochs, with a linear warmup
    over the first max(warmup_epochs · steps_per_epoch, 100) data iterations
    from 0 (g0, g1) or warmup_bias_lr (g2). One inner step is `accumulate`
    data iterations."""
    lr0 = hyp.get("lr0", 0.01)
    lrf = hyp.get("lrf", 0.01)
    nw = _warmup_iters(hyp, steps_per_epoch)
    warm_start = f32(hyp.get("warmup_bias_lr", 0.1) if group == "g2" else 0.0)

    def sched(step: int) -> float:
        ni = step * accumulate
        e = min(f32(ni) / f32(steps_per_epoch), f32(epochs - 1e-6))
        base = f32(lr0) * _lf(np.floor(e), epochs, lrf, cos_lr)
        frac = f32(min(max(f32(ni) / f32(nw), f32(0)), f32(1)))
        return float(warm_start + (base - warm_start) * frac if ni < nw else base)

    return sched


def build_momentum_schedule(hyp: Dict, steps_per_epoch: int, accumulate: int = 1) -> Callable[[int], float]:
    """Momentum (Adam's b1) at inner step `step`: linear from warmup_momentum
    to momentum over the warmup iterations."""
    m0, m1 = hyp.get("warmup_momentum", 0.8), hyp.get("momentum", 0.937)
    nw = _warmup_iters(hyp, steps_per_epoch)

    def sched(step: int) -> float:
        frac = f32(min(max(f32(step * accumulate) / f32(nw), f32(0)), f32(1)))
        return float(f32(m0) + f32(m1 - m0) * frac)

    return sched


class SmartOptimizer:
    """The three-group optimizer over a model's parameters, with gradient
    accumulation as optax.MultiSteps does it (JAX optim.py:252-253): every call
    of `step()` folds the parameters' `.grad` into a running mean,
    acc ← acc + (g − acc) / (n + 1) for the n-th micro-step of the cycle, and
    every `accumulate`-th call applies the update to that mean and advances the
    inner step count. The reference sums the micro-steps' gradients instead
    (torch's .grad accumulation); the port copies JAX (ROADMAP §C). Updates are
    in place, over each group's tensors at once (torch._foreach_*)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], name: str, hyp: Dict,
                 decay: float, epochs: int, steps_per_epoch: int, cos_lr: bool = False,
                 accumulate: int = 1, bn_weights: Optional[Collection[str]] = None):
        self.kind = {"sgd": "sgd", "adam": "adam", "adamw": "adam", "rmsprop": "rms"}.get(name.lower())
        if self.kind is None:
            raise NotImplementedError(f"Optimizer {name} not implemented")
        self.groups: Dict[str, list] = {"g0": [], "g1": [], "g2": []}
        self.names: Dict[str, list] = {"g0": [], "g1": [], "g2": []}
        for n, p in named_params:
            if p.requires_grad:
                g = param_group_label(n, bn_weights)
                self.groups[g].append(p)
                self.names[g].append(n)
        self.frozen: Dict[str, list] = {g: [False] * len(ps) for g, ps in self.groups.items()}
        self.decay = float(decay)
        self.accumulate = int(accumulate)
        self.lr01 = build_lr_schedule(hyp, epochs, steps_per_epoch, cos_lr, "g0", accumulate)
        self.lr2 = build_lr_schedule(hyp, epochs, steps_per_epoch, cos_lr, "g2", accumulate)
        self.momentum = build_momentum_schedule(hyp, steps_per_epoch, accumulate)
        self.count = 0       # inner (real) steps
        self.mini_step = 0   # micro-steps into the current accumulation cycle
        zeros = lambda: {g: [torch.zeros_like(p) for p in ps] for g, ps in self.groups.items()}  # noqa: E731
        self.acc = zeros() if self.accumulate > 1 else None
        self.m1 = zeros() if self.kind in ("sgd", "adam") else None
        self.m2 = zeros() if self.kind in ("adam", "rms") else None

    def state_dict(self) -> dict:
        """The counters and every buffer: the accumulator and the moments."""
        return {"count": self.count, "mini_step": self.mini_step,
                **{k: getattr(self, k) for k in ("acc", "m1", "m2")}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        for k in ("acc", "m1", "m2"):
            mine, theirs = getattr(self, k), sd.get(k)
            if (mine is None) != (theirs is None):
                raise ValueError(f"optimizer state {k!r}: expected {'none' if mine is None else 'one'}")
            for g in mine or {}:
                if len(mine[g]) != len(theirs[g]):
                    raise ValueError(f"optimizer state {k!r}[{g}]: {len(theirs[g])} tensors, "
                                     f"expected {len(mine[g])}")
                for a, b in zip(mine[g], theirs[g]):
                    a.copy_(b)

    def _grads(self, group: str):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.groups[group]]

    @torch.no_grad()
    def step(self) -> bool:
        """Take one micro-step; True when it applied an update to the parameters."""
        grads = {g: self._grads(g) for g, ps in self.groups.items() if ps}
        if self.acc is not None:
            for g, gr in grads.items():
                delta = torch._foreach_sub(gr, self.acc[g])
                torch._foreach_div_(delta, float(self.mini_step + 1))
                torch._foreach_add_(self.acc[g], delta)
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            self.mini_step = 0
            grads = {g: self.acc[g] for g in grads}
        c = self.count
        m = f32(self.momentum(c))
        for g, gr in grads.items():
            self._update(g, gr, self.lr2(c) if g == "g2" else self.lr01(c), m, c)
        if self.acc is not None:
            for g in grads:
                torch._foreach_zero_(self.acc[g])
        self.count += 1
        return True

    def _update(self, group, grads, lr, m, c):
        params = self.groups[group]
        wd = self.decay if group == "g0" else 0.0
        if self.kind == "sgd":
            g = torch._foreach_add(grads, params, alpha=wd) if wd else grads
            m1 = self.m1[group]
            torch._foreach_mul_(m1, float(m))
            torch._foreach_add_(m1, g)                       # trace: m1 = g + m·m1
            u = torch._foreach_mul(m1, float(m))
            torch._foreach_add_(u, g)                        # Nesterov: g + m·m1
        elif self.kind == "adam":
            b2, eps = f32(0.999), 1e-8
            m1, m2 = self.m1[group], self.m2[group]
            torch._foreach_mul_(m1, float(m))
            torch._foreach_add_(m1, grads, alpha=float(f32(1) - m))
            torch._foreach_mul_(m2, float(b2))
            torch._foreach_addcmul_(m2, grads, grads, value=float(f32(1) - b2))
            u = torch._foreach_div(m1, float(f32(1) - m ** f32(c + 1)))
            nu = torch._foreach_div(m2, float(f32(1) - b2 ** f32(c + 1)))
            torch._foreach_sqrt_(nu)
            torch._foreach_add_(nu, eps)
            torch._foreach_div_(u, nu)
            if wd:
                torch._foreach_add_(u, params, alpha=wd)
        else:  # RMSProp
            m2 = self.m2[group]
            torch._foreach_mul_(m2, 0.9)
            torch._foreach_addcmul_(m2, grads, grads, value=0.1)
            d = torch._foreach_add(m2, 1e-8)
            torch._foreach_sqrt_(d)
            u = torch._foreach_div(grads, d)
            if wd:
                torch._foreach_add_(u, params, alpha=wd)
        frozen = self.frozen[group]
        if any(frozen):  # freeze_layers: the moments move on, the parameters do not
            params = [p for p, f in zip(params, frozen) if not f]
            u = [x for x, f in zip(u, frozen) if not f]
        if params:
            torch._foreach_add_(params, u, alpha=-lr)


def smart_optimizer(model_or_params, name: str = "SGD", hyp: Optional[Dict] = None,
                    epochs: int = 100, steps_per_epoch: int = 100, cos_lr: bool = False,
                    accumulate: int = 1, total_batch_size: Optional[int] = None,
                    nominal_batch_size: int = 64) -> SmartOptimizer:
    """The three-group optimizer over a module's named parameters, its
    BatchNorm and LayerNorm weights in g1 (or over an iterable of (name, parameter), g1 then
    being the weights of modules named `bn`). Weight decay is scaled by
    total_batch_size · accumulate / nominal_batch_size when the batch size is
    given (reference segment/train.py:444-446)."""
    hyp = dict(hyp or {})
    decay = hyp.get("weight_decay", 5e-4)
    if total_batch_size is not None:
        decay = decay * total_batch_size * accumulate / nominal_batch_size
    if isinstance(model_or_params, nn.Module):
        named, bn = model_or_params.named_parameters(), batchnorm_weights(model_or_params)
    else:
        named, bn = model_or_params, None
    opt = SmartOptimizer(named, name, hyp, decay, epochs, steps_per_epoch, cos_lr, accumulate, bn)
    LOGGER.info(f"optimizer: {name}(lr={hyp.get('lr0', 0.01)}) with groups "
                f"{len(opt.groups['g0'])} weight(decay={decay:.5g}), {len(opt.groups['g1'])} "
                f"weight(decay=0.0), {len(opt.groups['g2'])} bias; accumulate {accumulate}")
    return opt


def freeze_layers(optimizer: SmartOptimizer, freeze) -> SmartOptimizer:
    """Zero the updates of the frozen graph layers (JAX optim.py:261; reference
    --freeze, segment/train.py:429-431): a single [N] freezes layers 0..N-1, a
    longer list exactly those layer indices. Parameters `model.{i}.…` of a
    frozen layer i keep their values; their gradients and optimizer moments
    are still computed, and weight decay does not shrink them."""
    frozen = set(freeze if len(freeze) > 1 else range(freeze[0]))
    n = 0
    for g, names in optimizer.names.items():
        for j, name in enumerate(names):
            parts = name.split(".")
            if parts[0] == "model" and len(parts) > 1 and parts[1].isdigit() \
                    and int(parts[1]) in frozen:
                optimizer.frozen[g][j] = True
                n += 1
    LOGGER.info(f"freezing {sorted(frozen)} -> {n} frozen parameter tensors")
    return optimizer
