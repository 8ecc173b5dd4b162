"""Optimizer: three parameter groups, warmup-aware schedules and gradient
accumulation (port of yolo_dual_tpu/train/optim.py; reference
utils/torch_utils.py:318-346 smart_optimizer and the warmup of
segment/train.py:521-529).

Groups: g0 = weights, with weight decay; g1 = BatchNorm weights, no decay;
g2 = biases, no decay, whose warmup starts at `warmup_bias_lr`. The update is
the math of the JAX package's fused optimizer (`_fused_smart_optimizer`):
SGD with Nesterov momentum, Adam/AdamW with decoupled decay, RMSProp. The
schedules are evaluated in float32 at the inner step count before it is
incremented, times `accumulate`, as there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from yolo_dual_tpu_torch.utils.general import LOGGER

f32 = np.float32


def param_group_label(name: str) -> str:
    """g0: weights with decay; g1: BatchNorm weights; g2: biases (torch names:
    `model.2.cv1.bn.weight` is g1, every `*.bias` is g2)."""
    parts = name.split(".")
    if parts[-1] == "bias":
        return "g2"
    if parts[-1] == "weight" and "bn" in parts[:-1]:
        return "g1"
    return "g0"


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
                 accumulate: int = 1):
        self.kind = {"sgd": "sgd", "adam": "adam", "adamw": "adam", "rmsprop": "rms"}.get(name.lower())
        if self.kind is None:
            raise NotImplementedError(f"Optimizer {name} not implemented")
        self.groups: Dict[str, list] = {"g0": [], "g1": [], "g2": []}
        for n, p in named_params:
            if p.requires_grad:
                self.groups[param_group_label(n)].append(p)
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
        torch._foreach_add_(params, u, alpha=-lr)


def smart_optimizer(model_or_params, name: str = "SGD", hyp: Optional[Dict] = None,
                    epochs: int = 100, steps_per_epoch: int = 100, cos_lr: bool = False,
                    accumulate: int = 1, total_batch_size: Optional[int] = None,
                    nominal_batch_size: int = 64) -> SmartOptimizer:
    """The three-group optimizer over a module's named parameters (or an
    iterable of (name, parameter)). Weight decay is scaled by
    total_batch_size · accumulate / nominal_batch_size when the batch size is
    given (reference segment/train.py:444-446)."""
    hyp = dict(hyp or {})
    decay = hyp.get("weight_decay", 5e-4)
    if total_batch_size is not None:
        decay = decay * total_batch_size * accumulate / nominal_batch_size
    named = model_or_params.named_parameters() if isinstance(model_or_params, torch.nn.Module) \
        else model_or_params
    opt = SmartOptimizer(named, name, hyp, decay, epochs, steps_per_epoch, cos_lr, accumulate)
    LOGGER.info(f"optimizer: {name}(lr={hyp.get('lr0', 0.01)}) with groups "
                f"{len(opt.groups['g0'])} weight(decay={decay:.5g}), {len(opt.groups['g1'])} "
                f"weight(decay=0.0), {len(opt.groups['g2'])} bias; accumulate {accumulate}")
    return opt
