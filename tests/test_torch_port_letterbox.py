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
    COLS,
    ROWS,
    axis_taps,
    launch_record,
    letterbox_geometry,
    letterbox_launch_record,
    letterbox_tables,
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


# The CUDA kernel (csrc/letterbox.cu runs only on the card): its tap tables, a
# numpy mirror of its arithmetic, its grid, and the launch records.

GEOMETRIES = [  # (h, w, s, scaleup)
    (1080, 1920, 640, True),   # exact 3:1, the second tap of every row weight 0
    (720, 1280, 640, True),    # exact 2:1
    (480, 640, 640, True),     # 1:1
    (240, 320, 640, True),     # 2x upscale
    (240, 320, 640, False),    # pads instead
    (333, 1137, 320, True),    # odd widths and heights, a row stride not 16-byte aligned
    (1137, 333, 320, True),    # portrait, odd left
    (40, 30, 102, True),       # S not a multiple of 4
    (1, 1, 64, True),
    (2, 3, 64, True),
    (10, 12, 96, True),        # 8x upscale
    (3, 7, 640, False),        # fewer rows than a block's
    (2160, 7680, 640, True),   # a wide row
]


def _cpu_record(h, w, s, scaleup, fill=114.0):
    return letterbox_launch_record(h, w, s, fill, scaleup, torch.device("cpu"))


def _kernel_mirror(x, s, fill, scaleup, both):
    """What csrc/letterbox.cu computes, in numpy float32: per content row the
    frame rows of its taps blended horizontally (a second column tap of weight
    0 skipped unless `both`), then vertically with row weights times 1/255 (a
    second row of weight 0 skipped unless `both`); fill elsewhere."""
    n, h, w, _ = x.shape
    rec = _cpu_record(h, w, s, scaleup, fill)
    _, _, _, nh, nw, top, left = rec.geometry
    tables = rec.tables.numpy()
    rowtab, cols = tables[:nh], tables[nh:]
    w0s, w1s = (rowtab[:, 2:].copy().view(np.float32) * np.float32(1 / 255)).T
    u, v = cols[:, 2:].copy().view(np.float32).T
    out = np.full((n, 3, s, s), rec.fill, np.float32)
    frame_rows = x.reshape(n, h, w * 3).astype(np.float32)

    def blend(f):
        return np.stack([u * f[:, cols[:, 0] + c]
                         + (v * f[:, cols[:, 1] + c] if both else
                            np.where(v != 0, v * f[:, cols[:, 1] + c], 0))
                         for c in range(3)], 1)
    for o, (t0, t1) in enumerate(rowtab[:, :2]):
        val = w0s[o] * blend(frame_rows[:, t0])
        if both or w1s[o] != 0:
            val = val + w1s[o] * blend(frame_rows[:, t1])
        out[:, :, top + o, left:left + nw] = val
    return out


@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("h,w,s,scaleup", GEOMETRIES)
def test_kernel_mirror_matches_plain_version(h, w, s, scaleup, both):
    x = _frames((2, h, w, 3), seed=h * w + s)
    want = letterbox_normalize_reference(torch.from_numpy(x), s, fill=114.0, scaleup=scaleup)
    got = _kernel_mirror(x, s, 114.0, scaleup, both)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,s,scaleup", GEOMETRIES)
def test_tap_tables_are_axis_taps(h, w, s, scaleup):
    """The tables hold `axis_taps`'s taps and weights bit for bit, a second
    tap of weight 0 repeating the first, the columns' taps as byte offsets."""
    rec = _cpu_record(h, w, s, scaleup)
    nh = rec.geometry[3]
    tables = rec.tables.numpy()
    for tab, n_in, n_out, scale in ((tables[:nh], h, nh, 1), (tables[nh:], w, rec.geometry[4], 3)):
        taps, weights = axis_taps(n_in, n_out)
        assert len(tab) == n_out
        np.testing.assert_array_equal(tab[:, :2], np.where(weights > 0, taps, taps[:, :1]) * scale)
        np.testing.assert_array_equal(tab[:, 2:], weights.view(np.int32))
    assert tables[nh:, :2].max() + 3 <= 3 * w


@pytest.mark.parametrize("h,w,s,scaleup", GEOMETRIES)
def test_rows_read_are_the_nonzero_taps(h, w, s, scaleup):
    """The frame rows and columns the kernel reads for each output row and
    column (a second tap only where its weight is not 0) are exactly the
    nonzero entries of that row of JAX's `_resize_matrix`: the premise of the
    byte bound."""
    rec = _cpu_record(h, w, s, scaleup)
    nh, nw = rec.geometry[3:5]
    tables = rec.tables.numpy()
    for tab, n_in, n_out, scale in ((tables[:nh], h, nh, 1), (tables[nh:], w, nw, 3)):
        dense = jax_resize_matrix(n_in, n_out)
        for o, (t0, t1, _, w1) in enumerate(tab):
            read = {t0 // scale} | ({t1 // scale} if w1 != 0 else set())
            assert read == set(np.flatnonzero(dense[o]).tolist()), (o, read)


@pytest.mark.parametrize("h,w,s,scaleup", GEOMETRIES)
def test_grid_covers_every_output_pixel_once(h, w, s, scaleup):
    """csrc/letterbox.cu's grid of (32 x ROWS)-thread blocks, COLS output
    columns a thread, writes every pixel of the canvas once; the launch takes
    the branch-free variant exactly where no tap has weight 0."""
    rec = _cpu_record(h, w, s, scaleup)
    p = rec.params
    assert (p.rows, p.cols) == (ROWS, COLS) and 32 * p.rows <= (256 if p.both else 512)
    covered = np.zeros((s, s), int)
    for by in range(-(-s // p.rows)):
        for bx in range(-(-s // (32 * p.cols))):
            for ty in range(p.rows):
                for tx in range(32):
                    y, x0 = by * p.rows + ty, p.cols * (bx * 32 + tx)
                    if y < s and x0 < s:
                        covered[y, x0:min(x0 + p.cols, s)] += 1
    assert (covered == 1).all()
    assert p.both == (rec.tables[:, 3] != 0).all().item()
    assert (p.H, p.W, p.S, p.nh, p.nw, p.top, p.left) == (h, w, s, *rec.geometry[3:])
    assert p.tables == rec.tables.data_ptr() and np.float32(p.fill) == np.float32(rec.fill)


def test_launch_record_cache_keys_on_the_geometry():
    cpu = torch.device("cpu")
    args = dict(h=48, w=64, s=64, fill=114.0, scaleup=True)
    first = launch_record(**args, device=cpu)
    assert launch_record(**args, device=cpu) is first
    for key, other in (("h", 47), ("w", 65), ("s", 96), ("fill", 128.0), ("scaleup", False)):
        changed = launch_record(**dict(args, **{key: other}), device=cpu)
        assert changed is not first
        assert launch_record(**dict(args, **{key: other}), device=cpu) is changed
    assert launch_record(**dict(args, fill=128.0), device=cpu).fill == \
        np.float32(128) / np.float32(255)
    assert first.tables.device == cpu and first.tables.dtype == torch.int32


def test_launch_records_are_never_evicted():
    """A CUDA graph captured with a record's launch reads its tables at each
    replay: the cache keeps every record however many geometries follow."""
    cpu = torch.device("cpu")
    first = launch_record(30, 40, 64, 114.0, True, cpu)
    for k in range(100):
        launch_record(8 + k, 9, 32, 114.0, True, cpu)
    assert launch_record(30, 40, 64, 114.0, True, cpu) is first
