"""Input normalization (port of yolo_dual_tpu/data/loader.py:normalize_image)."""

from __future__ import annotations

import torch


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; float tensors pass through unchanged."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x
