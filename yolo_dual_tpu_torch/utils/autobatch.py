"""AutoBatch: the largest batch whose eval forward fits the card (port of
yolo_dual_tpu/utils/autobatch.py; reference utils/autobatch.py:18-72).

JAX reads XLA's compile-time memory analysis; the port runs the forward at
each candidate and reads torch.cuda.max_memory_allocated around it (the
parameters, the input, the activations and the output), against `fraction`
of the card's memory from torch.cuda.mem_get_info.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

import torch

from yolo_dual_tpu_torch.utils.general import LOGGER


def device_memory_bytes(default: int = 16 * 2 ** 30) -> int:
    """The current card's total memory (torch.cuda.mem_get_info), `default`
    without CUDA."""
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1])
    return default


def forward_bytes(model, bs: int, imgsz: int) -> int:
    """Peak bytes allocated on the card while `model` runs its eval forward on
    a (bs, 3, imgsz, imgsz) float32 batch."""
    dev = next(model.parameters()).device
    kw = {"decode": False} if "decode" in inspect.signature(model.forward).parameters else {}
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        x = torch.zeros(bs, 3, imgsz, imgsz, device=dev)
        out = model(x, **kw)
        del x, out
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def autobatch(model, imgsz: int = 640, fraction: float = 0.8,
              candidates=(1, 2, 4, 8, 16, 32, 64, 128),
              measure: Callable[..., int] = forward_bytes, record: Optional[dict] = None) -> int:
    """The largest candidate batch whose forward fits `fraction` of the card's
    memory: candidates are tried in order and the first that does not fit,
    or runs out of memory, stops the search; any other error (a kernel that
    does not build or launch) is raised. `record`, when given, gets
    {batch: bytes} of each one measured."""
    model.eval()
    limit = device_memory_bytes() * fraction
    best = candidates[0]
    for bs in candidates:
        try:
            total = measure(model, bs, imgsz)
        except torch.cuda.OutOfMemoryError:
            LOGGER.info(f"autobatch: bs={bs} ran out of memory; using {best}")
            break
        if record is not None:
            record[bs] = total
        LOGGER.info(f"autobatch: bs={bs} {total / 2 ** 30:.3f} GiB")
        if total > limit:
            break
        best = bs
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    LOGGER.info(f"autobatch: using batch size {best} (limit {limit / 2 ** 30:.1f} GiB)")
    return best
