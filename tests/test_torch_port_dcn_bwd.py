"""The DCNv3 sampling gradient (K3's plain version) against the JAX package:
the port's `dcnv3_core_bwd` against JAX's `nn/dcn.py:dcnv3_core_bwd` and
against the Pallas backward kernel `_dcnv3_banded_bwd` in interpret mode, and
`gradcheck` of the autograd Function `dcnv3_sampling` in float64 on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerance: atol
1e-4 and rtol 1e-4 in float32 (the frameworks sum in different orders); the
gradcheck uses torch's float64 defaults. Offsets are N(0, 2 px) or wider, so
no sample lies on an integer position, where the bilinear has no derivative.
In bfloat16 the wrapper's CPU path is held against the Pallas backward on the
same bfloat16 inputs: JAX's output types, each value within one bfloat16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import CORE_CASES, bf16_ulp_gap, sampling_inputs, to_bfloat16
from yolo_dual_tpu.kernels.dcn_sampling import _dcnv3_banded_bwd
from yolo_dual_tpu.nn import dcn as JD
from yolo_dual_tpu_torch.kernels.dcn_sampling import (
    dcnv3_core_bwd, dcnv3_sampling, dcnv3_sampling_backward)

TOL = dict(rtol=1e-4, atol=1e-4)


def with_grad_out(seed, x, offset):
    b, ho, wo = offset.shape[:3]
    return np.random.default_rng(seed).standard_normal((b, ho, wo, x.shape[3])).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_dcnv3_core_bwd_matches_jax(name):
    b, h, w, g, gc, k, s, p, d, scale, std = CORE_CASES[name]
    x, offset, mask = sampling_inputs(len(name), b, h, w, g, gc, k, s, std)
    gout = with_grad_out(len(name) + 1, x, offset)
    want = JD.dcnv3_core_bwd(*(jnp.asarray(a) for a in (x, offset, mask, gout)),
                             k, s, p, d, g, gc, scale)
    got = dcnv3_core_bwd(*(torch.from_numpy(a) for a in (x, offset, mask, gout)),
                         k, s, p, d, g, gc, scale)
    for name_, a, r in zip(("dx", "doffset", "dmask"), got, want):
        assert a.shape == r.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL, err_msg=name_)
    # the wrapper's CPU path is the plain version
    wrapped = dcnv3_sampling_backward(*(torch.from_numpy(a) for a in (x, offset, mask, gout)),
                                      k, s, p, d, g, gc, scale)
    for a, r in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), r.numpy())


def pallas_bwd_case(case):
    """(x, offset, mask, gout, g, gc, k) of the Pallas backward comparisons:
    "in_band", or "band_escape", whose Δy 15 on 24 rows leaves the kernel's
    16-row band and takes its escape to the lax backward."""
    b, h, w, g, gc, k = (2, 9, 8, 2, 4, 3) if case == "in_band" else (1, 24, 8, 1, 4, 3)
    x, offset, mask = sampling_inputs(7, b, h, w, g, gc, k)
    if case == "band_escape":
        offset[..., 1::2] = 15.0
    return x, offset, mask, with_grad_out(8, x, offset), g, gc, k


@pytest.mark.parametrize("case", ["in_band", "band_escape"])
def test_dcnv3_core_bwd_matches_pallas_kernel(case):
    """The plain backward against the JAX package's Pallas backward kernel,
    run as tests/test_kernels.py runs it (interpret mode)."""
    x, offset, mask, gout, g, gc, k = pallas_bwd_case(case)
    want = _dcnv3_banded_bwd(*(jnp.asarray(a) for a in (x, offset, mask, gout)), kernel=k, pad=1,
                             dilation=1, group=g, group_channels=gc, offset_scale=1.0,
                             interpret=True)
    got = dcnv3_core_bwd(*(torch.from_numpy(a) for a in (x, offset, mask, gout)),
                         k, 1, 1, 1, g, gc, 1.0)
    for name_, a, r in zip(("dx", "doffset", "dmask"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL, err_msg=name_)


@pytest.mark.parametrize("case", ["in_band", "band_escape"])
def test_dcnv3_sampling_backward_bfloat16_matches_pallas_kernel(case):
    """bfloat16 x, offset, mask and output gradient: the wrapper's CPU path
    (the plain backward, in float32 from the bfloat16 values) against JAX's
    Pallas backward in interpret mode on the same bfloat16 inputs, which
    returns dx, doffset and dmask in their inputs' types
    (kernels/dcn_sampling.py:478): those types, and each value within one
    bfloat16 ulp of JAX's (float32 sums added in another order, then rounded)."""
    x, offset, mask, gout, g, gc, k = pallas_bwd_case(case)
    port, ref = to_bfloat16(x, offset, mask, gout)
    want = _dcnv3_banded_bwd(*ref, kernel=k, pad=1, dilation=1, group=g, group_channels=gc,
                             offset_scale=1.0, interpret=True)
    got = dcnv3_sampling_backward(*port, k, 1, 1, 1, g, gc, 1.0)
    for name_, a, r in zip(("dx", "doffset", "dmask"), got, want):
        assert r.dtype == jnp.bfloat16 and a.dtype == torch.bfloat16, name_
        assert a.shape == r.shape, name_
        assert bf16_ulp_gap(a, r) <= 1.0, name_


@pytest.mark.parametrize("name", ["g1", "g2", "stride2", "dilation2_k5", "offset_scale2",
                                  "far_outside"])
def test_dcnv3_sampling_gradcheck(name):
    """Finite differences of the plain forward against the autograd Function's
    backward (the plain `dcnv3_core_bwd` on the CPU), in float64."""
    b, h, w, g, gc, k, s, p, d, scale, std = CORE_CASES[name]
    # few inputs: gradcheck perturbs each one
    h, w, gc = (4, 4, 2) if k == 5 else (min(h, 6), min(w, 6), min(gc, 3))
    x, offset, mask = (torch.from_numpy(a).double().requires_grad_() for a in
                       sampling_inputs(len(name), 1, h, w, g, gc, k, s, std))

    def fn(x, offset, mask):
        return dcnv3_sampling(x, offset, mask, k, s, p, d, g, gc, scale)
    assert torch.autograd.gradcheck(fn, (x, offset, mask))


def test_dcnv3_sampling_backward_on_cpu():
    """On CPU tensors the Function's backward is the plain one, launches
    nothing, and the wrapper checks the gradient's shape."""
    x, offset, mask = (torch.from_numpy(a).requires_grad_() for a in
                       sampling_inputs(0, 1, 5, 6, 2, 3, 3))
    gout = torch.from_numpy(with_grad_out(1, x, offset))
    launches = (dcnv3_sampling.launches, dcnv3_sampling_backward.launches)
    dcnv3_sampling(x, offset, mask, 3, 1, 1, 1, 2, 3, 1.0).backward(gout)
    assert (dcnv3_sampling.launches, dcnv3_sampling_backward.launches) == launches
    want = dcnv3_core_bwd(x.detach(), offset.detach(), mask.detach(), gout, 3, 1, 1, 1, 2, 3, 1.0)
    for t, r in zip((x, offset, mask), want):
        np.testing.assert_array_equal(t.grad.numpy(), r.numpy())
    with pytest.raises(ValueError, match="grad_out"):
        dcnv3_sampling_backward(x.detach(), offset.detach(), mask.detach(), gout[:, :4],
                                3, 1, 1, 1, 2, 3, 1.0)
