"""Model pruning (port of yolo_dual_tpu/utils/prune.py; reference
utils/torch_utils.py prune and sparsity): L1-unstructured pruning of every
convolution and linear weight, one threshold a tensor."""

from __future__ import annotations

import torch
import torch.nn as nn

from yolo_dual_tpu_torch.utils.general import LOGGER

# JAX prunes the leaves named `kernel`: the weights of flax's Conv, ConvTranspose and Dense
PRUNED = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)


@torch.no_grad()
def prune(model: nn.Module, amount: float = 0.3):
    """Zero, in place, the `amount` smallest-magnitude fraction of every
    convolution and linear weight of 2 or more dimensions: the entries at or
    below the k-th smallest |w|, k = int(numel · amount), as JAX's
    np.partition threshold does (torch's prune.l1_unstructured keeps ties
    past k). Returns (model, the zeroed share of all parameters)."""
    zeroed = 0
    total = sum(p.numel() for p in model.parameters())
    for m in model.modules():
        w = getattr(m, "weight", None)
        if not isinstance(m, PRUNED) or w is None or w.ndim < 2:
            continue
        k = int(w.numel() * amount)
        if k <= 0:
            continue
        thresh = w.abs().flatten().kthvalue(k).values
        keep = w.abs() > thresh
        zeroed += int((~keep).sum())
        w.mul_(keep)
    share = zeroed / max(total, 1)
    LOGGER.info(f"pruned model to {share:.3f} global sparsity ({zeroed:,}/{total:,} weights zeroed)")
    return model, share


def sparsity(model: nn.Module) -> float:
    """The share of the parameters (not the buffers) that are exactly zero."""
    params = list(model.parameters())
    zeros = sum(int((p == 0).sum()) for p in params)
    return zeros / max(sum(p.numel() for p in params), 1)
