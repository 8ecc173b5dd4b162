"""Profiling and model introspection (port of yolo_dual_tpu/utils/profiling.py;
reference utils/torch_utils.py:151-199 profile, :272-295 model_info).

FLOPs come from torch.utils.flop_counter.FlopCounterMode, which counts the
matrix products and convolutions (2 per multiply-add) and nothing
elementwise; XLA's cost analysis, which JAX's reads, also counts the
elementwise operations (BatchNorm, activations, the head's decode), so JAX's
totals are higher. The DCNv3 sampling (a hand-written kernel on the card, a
gather on the CPU) is counted by its own formula, 11 operations per output
value and sample point (the bilinear blend of four taps and the masked
accumulate), through a forward hook on each DCNv3 module.
"""

from __future__ import annotations

import inspect
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yolo_dual_tpu_torch.utils.general import LOGGER

DCNV3_OPS_PER_POINT = 11


def dcnv3_flops(module, out: torch.Tensor) -> int:
    """Operations of one DCNv3 module's sampling: its output (B, Ho, Wo, C)
    values, each a sum over kernel² sample points."""
    return DCNV3_OPS_PER_POINT * out.numel() * module.kernel_size ** 2


def _sync(args):
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        torch.cuda.synchronize()


def flops_of(fn, *args, model: Optional[torch.nn.Module] = None) -> Optional[float]:
    """Total FLOPs of one call fn(*args), with the DCNv3 modules of `model`
    counted by their formula; None when the call fails."""
    from torch.utils.flop_counter import FlopCounterMode
    from yolo_dual_tpu_torch.nn.dcn import DCNv3
    extra = []
    hooks = [m.register_forward_hook(lambda m, i, o: extra.append(dcnv3_flops(m, o)))
             for m in (model.modules() if model is not None else ()) if isinstance(m, DCNv3)]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops() + sum(extra))
    except Exception as e:
        LOGGER.info(f"flop count failed: {e}")
        return None
    finally:
        for h in hooks:
            h.remove()


def _forward(model):
    """model's eval forward of an NCHW float batch, undecoded where it decodes."""
    kw = {"decode": False} if "decode" in inspect.signature(model.forward).parameters else {}
    return lambda x: model(x, **kw)


def model_info(model, imgsz: int = 640, verbose: bool = False):
    """(layers, parameters, GFLOPs of an eval forward at 1 x 3 x imgsz x imgsz)
    (reference model_info, utils/torch_utils.py:272)."""
    n_params = sum(p.numel() for p in model.parameters())
    layers = getattr(model, "model", None)
    n_layers = len(layers) if layers is not None else len(list(model.children()))
    dev = next(model.parameters()).device
    x = torch.zeros(1, 3, imgsz, imgsz, device=dev)
    was_training = model.training
    model.eval()
    fl = flops_of(_forward(model), x, model=model)
    model.train(was_training)
    gflops = (fl or 0.0) / 1e9
    LOGGER.info(f"Model summary: {n_layers} layers, {n_params:,} parameters, "
                f"{gflops:.1f} GFLOPs @ {imgsz}x{imgsz}")
    if verbose and layers is not None:
        for i, layer in enumerate(layers):
            LOGGER.info(f"{i:>3} {type(layer).__name__:<18} f={getattr(layer, 'f', '')}")
    return n_layers, n_params, gflops


def profile(fn, *args, n: int = 10, warmup: int = 2, label: str = "",
            model: Optional[torch.nn.Module] = None):
    """Latency of fn(*args) (reference profile(), utils/torch_utils.py:151):
    a first call, `warmup` more, then `n` timed calls, each waited for
    (torch.cuda.synchronize when an argument is on the card). Returns (min s,
    median s, FLOPs of one call or None)."""
    with torch.no_grad():
        for _ in range(1 + warmup):
            fn(*args)
        _sync(args)
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(*args)
            _sync(args)
            ts.append(time.perf_counter() - t0)
    fl = flops_of(fn, *args, model=model)
    LOGGER.info(f"profile {label}: min {min(ts) * 1e3:.2f} ms, median {np.median(ts) * 1e3:.2f} ms"
                + (f", {fl / min(ts) / 1e12:.2f} TFLOP/s" if fl else ""))
    return min(ts), float(np.median(ts)), fl


def trace(fn, *args, log_dir: str = "runs/profile"):
    """One call of fn(*args) under torch.profiler (the card's kernels through
    CUPTI where CUDA is up), written as a chrome trace `log_dir`/trace.json.
    Returns the call's result."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.no_grad(), tprofile(activities=acts) as prof:
        r = fn(*args)
        _sync(args)
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    LOGGER.info(f"profiler trace written to {log_dir / 'trace.json'}")
    return r


def _lead(out) -> torch.Tensor:
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


def check_bf16(model, imgsz: int = 256, atol: float = 0.5) -> bool:
    """The eval forward under torch.autocast(bfloat16) against float32 on one
    seeded frame, the first output held within atol 0.5, rtol 0.1 as JAX's
    (reference check_amp, utils/general.py:566-593)."""
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, imgsz, imgsz, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2).contiguous().to(dev)
    fwd = _forward(model.eval())
    with torch.no_grad():
        lead32 = _lead(fwd(x)).float()
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            lead16 = _lead(fwd(x)).float()
    ok = bool(torch.allclose(lead32, lead16, atol=atol, rtol=0.1))
    LOGGER.info(f"bf16 check: {'PASS' if ok else 'FAIL'} "
                f"(max abs diff {float((lead32 - lead16).abs().max()):.4f})")
    return ok
