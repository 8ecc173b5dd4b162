"""The port's CUDA kernels on the card: each kernel against its plain torch
version, over the options the main path does not reach, and the wrappers'
refusals. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it runs on a GPU machine
that has neither; tests/conftest.py imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: 1e-5 absolute on values of order 1, the limit chip_smoke.py holds
the kernels to; the kernel and the plain version sum in other orders.
"""

import numpy as np
import pytest
import torch

from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_core, dcnv3_sampling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sampling_inputs(seed, b, h, w, g, gc, k, stride=1, offset_std=2.0, integer=False):
    rng = np.random.default_rng(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.standard_normal((b, h, w, g * gc)).astype(np.float32)
    offset = rng.standard_normal((b, ho, wo, g * k * k * 2)) * offset_std
    if integer:  # every sample on a pixel center, many exactly on or just past the edge
        offset = np.round(offset)
    logits = rng.standard_normal((b, ho, wo, g, k * k))
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, offset.astype(np.float32), mask.reshape(b, ho, wo, g * k * k).astype(np.float32)


CASES = {  # name: (b, h, w, g, gc, k, stride, pad, dilation, offset_scale, offset_std, integer)
    "g1_c64": (2, 12, 11, 1, 64, 3, 1, 1, 1, 1.0, 2.0, False),
    "g2": (2, 8, 9, 2, 4, 3, 1, 1, 1, 1.0, 2.0, False),
    "g3_c15": (1, 7, 9, 3, 5, 3, 1, 1, 1, 1.0, 2.0, False),
    "c320_channel_loop": (1, 5, 6, 2, 160, 3, 1, 1, 1, 1.0, 2.0, False),
    "offset_scale2": (1, 7, 6, 2, 3, 3, 1, 1, 1, 2.0, 2.0, False),
    "stride2": (1, 10, 8, 1, 5, 3, 2, 1, 1, 1.0, 2.0, False),
    "dilation2_k5": (1, 9, 9, 2, 2, 5, 1, 4, 2, 1.0, 1.5, False),
    "far_outside": (1, 6, 7, 2, 3, 3, 1, 1, 1, 1.0, 8.0, False),
    "integer_edges": (2, 6, 6, 1, 32, 3, 1, 1, 1, 1.0, 1.5, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dcnv3_kernel_matches_plain(cuda, name):
    b, h, w, g, gc, k, s, p, d, scale, std, integer = CASES[name]
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(len(name), b, h, w, g, gc, k, s, std, integer))
    want = dcnv3_core(x, offset, mask, k, s, p, d, g, gc, scale)
    before = dcnv3_sampling.launches
    got = dcnv3_sampling(x, offset, mask, k, s, p, d, g, gc, scale)
    torch.cuda.synchronize()
    assert dcnv3_sampling.launches == before + 1
    assert got.shape == want.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-5


def test_dcnv3_raises_where_a_gradient_is_needed(cuda):
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in sampling_inputs(0, 1, 6, 6, 1, 8, 3))
    with pytest.raises(NotImplementedError, match="_dcnv3_banded_bwd"):
        dcnv3_sampling(x.requires_grad_(), offset, mask, 3, 1, 1, 1, 1, 8, 1.0)
    with torch.no_grad():
        assert dcnv3_sampling(x, offset, mask, 3, 1, 1, 1, 1, 8, 1.0).shape == (1, 6, 6, 8)


def test_dcnv3_rejects_what_the_kernel_does_not_take(cuda):
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in sampling_inputs(1, 1, 6, 6, 1, 8, 3))
    with pytest.raises(ValueError, match="contiguous"):
        dcnv3_sampling(x.transpose(1, 2), offset, mask, 3, 1, 1, 1, 1, 8, 1.0)
    with pytest.raises(ValueError, match="one device"):
        dcnv3_sampling(x, offset.cpu(), mask, 3, 1, 1, 1, 1, 8, 1.0)
    with pytest.raises(TypeError, match="float32"):
        dcnv3_sampling(x.half(), offset, mask, 3, 1, 1, 1, 1, 8, 1.0)
