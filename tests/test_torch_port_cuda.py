"""The port's CUDA kernels on the card: each kernel against its plain torch
version, over the options the main path does not reach, and the wrappers'
refusals. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it runs on a GPU machine
that has neither; tests/conftest.py imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: 1e-5 absolute on values of order 1, the limit chip_smoke.py holds
the kernels to; the kernel and the plain version sum in other orders. The
backward kernel is held to 1e-5 relative to the largest magnitude of each
gradient: dx sums its adds, in a shared-memory window and then into device
memory, by float atomics in an order that changes from run to run, and doffset
sums over the group's channels.
"""

import numpy as np
import pytest
import torch

from yolo_dual_tpu_torch.kernels.dcn_sampling import (
    WINDOW_MARGIN, dcnv3_core, dcnv3_core_bwd, dcnv3_sampling, dcnv3_sampling_backward)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sampling_inputs(seed, b, h, w, g, gc, k, stride=1, offset_std=2.0, kind="normal"):
    """Seeded inputs; the offsets by `kind`: "normal" N(0, offset_std) px;
    "integer" the same rounded, so every sample lies on a pixel center, many
    exactly on or just past the image's edge; "window_edge" ±R or ±(R + 1) px
    for the window margin R, so samples of a tile's edge pixels lie exactly on
    or just past the window's edge; "far" ±1e4 px, so every sample leaves the
    window and the image."""
    rng = np.random.default_rng(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.standard_normal((b, h, w, g * gc)).astype(np.float32)
    shape = (b, ho, wo, g * k * k * 2)
    if kind == "window_edge":
        r = WINDOW_MARGIN
        offset = rng.choice([-r - 1, -r, r, r + 1], shape).astype(np.float64)
    elif kind == "far":
        offset = rng.choice([-1e4, 1e4], shape) + rng.uniform(-0.5, 0.5, shape)
    else:
        offset = rng.standard_normal(shape) * offset_std
        if kind == "integer":
            offset = np.round(offset)
    logits = rng.standard_normal((b, ho, wo, g, k * k))
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, offset.astype(np.float32), mask.reshape(b, ho, wo, g * k * k).astype(np.float32)


CASES = {  # name: (b, h, w, g, gc, k, stride, pad, dilation, offset_scale, offset_std, kind)
    "g1_c64": (2, 12, 11, 1, 64, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "g2": (2, 8, 9, 2, 4, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "g3_c15": (1, 7, 9, 3, 5, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "c320_channel_loop": (1, 5, 6, 2, 160, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "offset_scale2": (1, 7, 6, 2, 3, 3, 1, 1, 1, 2.0, 2.0, "normal"),
    "stride2": (1, 10, 8, 1, 5, 3, 2, 1, 1, 1.0, 2.0, "normal"),
    "dilation2_k5": (1, 9, 9, 2, 2, 5, 1, 4, 2, 1.0, 1.5, "normal"),
    "far_outside": (1, 6, 7, 2, 3, 3, 1, 1, 1, 1.0, 8.0, "normal"),
    "integer_edges": (2, 6, 6, 1, 32, 3, 1, 1, 1, 1.0, 1.5, "integer"),
    # the window design: samples across tile borders, a map no tile divides, offsets on
    # and just past the window's edge, every sample escaping, the channel-chunk loop
    "multi_tile_80": (2, 80, 80, 1, 64, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "ragged_37x53": (1, 37, 53, 1, 64, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "window_edge": (2, 24, 40, 1, 64, 3, 1, 1, 1, 1.0, 0.0, "window_edge"),
    "window_edge_stride2_g2": (1, 30, 34, 2, 12, 3, 2, 1, 1, 1.0, 0.0, "window_edge"),
    "far_1e4": (2, 12, 11, 2, 16, 3, 1, 1, 1, 1.0, 0.0, "far"),
    "chunks_20x20x256": (1, 20, 20, 1, 256, 3, 1, 1, 1, 1.0, 2.0, "normal"),
    "gc160_multi_tile": (2, 24, 20, 1, 160, 3, 1, 1, 1, 1.0, 2.0, "normal"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dcnv3_kernel_matches_plain(cuda, name):
    b, h, w, g, gc, k, s, p, d, scale, std, kind = CASES[name]
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(len(name), b, h, w, g, gc, k, s, std, kind))
    want = dcnv3_core(x, offset, mask, k, s, p, d, g, gc, scale)
    before = dcnv3_sampling.launches
    got = dcnv3_sampling(x, offset, mask, k, s, p, d, g, gc, scale)
    torch.cuda.synchronize()
    assert dcnv3_sampling.launches == before + 1
    assert got.shape == want.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-5


def assert_grads_close(got, want):
    for name, a, b in zip(("dx", "doffset", "dmask"), got, want):
        assert a.shape == b.shape and a.is_contiguous(), name
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * max(1.0, b.abs().max().item()), (name, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dcnv3_backward_kernel_matches_plain(cuda, name):
    b, h, w, g, gc, k, s, p, d, scale, std, kind = CASES[name]
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(len(name), b, h, w, g, gc, k, s, std, kind))
    gout = torch.randn((b, *offset.shape[1:3], g * gc), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(len(name)))
    want = dcnv3_core_bwd(x, offset, mask, gout, k, s, p, d, g, gc, scale)
    before = dcnv3_sampling_backward.launches
    got = dcnv3_sampling_backward(x, offset, mask, gout, k, s, p, d, g, gc, scale)
    torch.cuda.synchronize()
    assert dcnv3_sampling_backward.launches == before + 1
    assert_grads_close(got, want)


def test_dcnv3_far_offsets_give_and_receive_nothing(cuda):
    """At ±1e4 px every sample leaves the window and the image: the forward is
    exactly 0 and no gradient reaches x, offset or mask."""
    b, h, w, g, gc, k, s, p, d, scale, std, kind = CASES["far_1e4"]
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(0, b, h, w, g, gc, k, s, std, kind))
    out = dcnv3_sampling(x, offset, mask, k, s, p, d, g, gc, scale)
    grads = dcnv3_sampling_backward(x, offset, mask, torch.ones_like(out), k, s, p, d, g, gc,
                                    scale)
    torch.cuda.synchronize()
    for t in (out, *grads):
        assert not t.any()


def test_dcnv3_backward_doffset_dmask_are_bitwise_stable(cuda):
    """doffset and dmask are reduced in a fixed order (one owner warp per sum,
    chunks in order): two calls give the same bits. dx, summed by atomics, only
    agrees to the tolerance."""
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(7, 2, 80, 80, 1, 64, 3))
    gout = torch.randn(2, 80, 80, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(7))
    first = dcnv3_sampling_backward(x, offset, mask, gout, 3, 1, 1, 1, 1, 64, 1.0)
    second = dcnv3_sampling_backward(x, offset, mask, gout, 3, 1, 1, 1, 1, 64, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert_grads_close(first, second)


def test_dcnv3_backward_launches_its_kernel_once(cuda):
    """The autograd backward of dcnv3_sampling launches K3 once, on the
    non-contiguous gradient a permute hands it, and matches the plain backward."""
    x, offset, mask = (torch.from_numpy(a).to(cuda).requires_grad_() for a in
                       sampling_inputs(0, 2, 6, 7, 1, 32, 3))
    before = (dcnv3_sampling.launches, dcnv3_sampling_backward.launches)
    out = dcnv3_sampling(x, offset, mask, 3, 1, 1, 1, 1, 32, 1.0)
    gout = torch.randn(2, 32, 6, 7, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    (out.permute(0, 3, 1, 2) * gout).sum().backward()
    torch.cuda.synchronize()
    assert (dcnv3_sampling.launches, dcnv3_sampling_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    want = dcnv3_core_bwd(x.detach(), offset.detach(), mask.detach(),
                          gout.permute(0, 2, 3, 1).contiguous(), 3, 1, 1, 1, 1, 32, 1.0)
    assert_grads_close((x.grad, offset.grad, mask.grad), want)


def test_dcnv3_rejects_what_the_kernel_does_not_take(cuda):
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in sampling_inputs(1, 1, 6, 6, 1, 8, 3))
    with pytest.raises(ValueError, match="contiguous"):
        dcnv3_sampling(x.transpose(1, 2), offset, mask, 3, 1, 1, 1, 1, 8, 1.0)
    with pytest.raises(ValueError, match="one device"):
        dcnv3_sampling(x, offset.cpu(), mask, 3, 1, 1, 1, 1, 8, 1.0)
    with pytest.raises(TypeError, match="float32"):
        dcnv3_sampling(x.half(), offset, mask, 3, 1, 1, 1, 1, 8, 1.0)
