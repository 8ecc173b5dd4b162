"""The port's letterbox (yolo_dual_tpu_torch/kernels/preprocess.py) against the
JAX Pallas kernel in interpret mode and the JAX numpy reference.

On a CPU tensor `letterbox_normalize` runs its plain torch version; the CUDA
kernel is held against that same plain version on the card by chip_smoke.py.
Outputs are compared after an NCHW -> NHWC transpose at atol 1e-5 (float32
sums taken in a different order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dual_tpu.kernels.preprocess import _resize_matrix as jax_resize_matrix
from yolo_dual_tpu.kernels.preprocess import letterbox_geometry as jax_letterbox_geometry
from yolo_dual_tpu.kernels.preprocess import letterbox_normalize as jax_letterbox_normalize
from yolo_dual_tpu.kernels.preprocess import letterbox_normalize_reference as jax_reference
from yolo_dual_tpu_torch.kernels.preprocess import (
    axis_taps,
    letterbox_geometry,
    letterbox_normalize,
    letterbox_normalize_reference,
)


def _frames(shape, seed, bars=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if bars:  # vertical bars: sharp column edges the resize must place exactly
        x[:, :, ::4] = 255
        x[:, :, 1::4] = 0
    return x


CASES = [  # (shape, out_size, fill, scaleup, bars)
    ((2, 48, 64, 3), 64, 114.0, True, True),    # downscale
    ((1, 40, 30, 3), 64, 114.0, True, False),   # upscale
    ((1, 40, 30, 3), 64, 114.0, False, False),  # scaleup=False pads instead
    ((1, 48, 96, 3), 64, 128.0, True, False),   # semantic fill
]


@pytest.mark.parametrize("shape,s,fill,scaleup,bars", CASES)
def test_letterbox_matches_pallas_interpret(shape, s, fill, scaleup, bars):
    x = _frames(shape, seed=sum(shape), bars=bars)
    want = np.asarray(jax_letterbox_normalize(jnp.asarray(x), out_size=s, fill=fill,
                                              interpret=True, scaleup=scaleup))
    got = letterbox_normalize(torch.from_numpy(x), s, fill=fill, scaleup=scaleup)
    assert got.shape == (shape[0], 3, s, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,s,fill,scaleup,bars", [c for c in CASES if c[3]])
def test_letterbox_matches_numpy_reference(shape, s, fill, scaleup, bars):
    # the JAX numpy reference has no scaleup flag: only scaleup=True cases
    x = _frames(shape, seed=sum(shape) + 1, bars=bars)
    want = jax_reference(x, out_size=s, fill=fill)
    got = letterbox_normalize_reference(torch.from_numpy(x), s, fill=fill)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(48, 64), (1080, 640), (1920, 1137), (5, 3), (7, 7)])
def test_axis_taps_rebuild_resize_matrix(n_in, n_out):
    taps, weights = axis_taps(n_in, n_out)
    dense = np.zeros((n_out, n_in), np.float64)
    for j in range(2):
        np.add.at(dense, (np.arange(n_out), taps[:, j]), weights[:, j])
    np.testing.assert_allclose(dense, jax_resize_matrix(n_in, n_out), rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,s,scaleup", [(1080, 1920, 640, True), (40, 30, 64, False),
                                           (480, 640, 640, True)])
def test_letterbox_geometry_matches(h, w, s, scaleup):
    assert letterbox_geometry(h, w, s, scaleup) == jax_letterbox_geometry(h, w, s, scaleup)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(1, 8, 8, 3), TypeError),                        # float frames
    (torch.zeros(1, 8, 8, 4, dtype=torch.uint8), ValueError),    # RGBA
    (torch.zeros(8, 8, 3, dtype=torch.uint8), ValueError),       # no batch dim
])
def test_letterbox_rejects_bad_input(bad, err):
    with pytest.raises(err):
        letterbox_normalize(bad, 16)
