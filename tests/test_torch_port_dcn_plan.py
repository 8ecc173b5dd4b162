"""The DCNv3 kernels' launch plan and build, on the CPU: what the card kernels
csrc/dcnv3.cu and csrc/dcnv3_bwd.cu are told to do, checked where no card is
needed.

- the plan of every DCNv3 call of yolov5s-seg-dcnv3 (at batch 1, 16 and 32,
  640 px) and of every card test case fits a block's 227 KB of shared memory,
  and its window holds every corner of every zero-offset sample of its tile;
- the plan is cached per shape, and the wrapper binds its ctypes functions once;
- a library's build hash covers the headers its source includes.
"""

import shutil

import numpy as np
import pytest
import torch

from test_torch_port_cuda import CASES
from yolo_dual_tpu_torch.kernels import build, dcn_sampling
from yolo_dual_tpu_torch.kernels.dcn_sampling import (
    CHUNK, SHARED_BYTES, SMS, WINDOW_MARGIN, blocks_per_sm, dcnv3_coords, dcnv3_plan,
    dcnv3_window_escapes)


def config_calls():
    """(b, h, w, ho, wo, kernel, stride, pad, dilation, group, group_channels,
    offset_scale) of each DCNv3 call of one yolov5s-seg-dcnv3 forward at 640
    px, at batch 1, 16 and 32: recorded from a forward on the meta device."""
    import yolo_dual_tpu_torch.nn.dcn as dcn
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cpu").to("meta")
    calls = []

    def record(x, offset, mask, *cfg):
        calls.append((*x.shape[1:3], *offset.shape[1:3], *cfg))
        return sampling(x, offset, mask, *cfg)
    sampling, dcn.dcnv3_sampling = dcn.dcnv3_sampling, record
    try:
        with torch.no_grad():
            model(torch.empty(1, 3, 640, 640, device="meta"), decode=False)
    finally:
        dcn.dcnv3_sampling = sampling
    return sorted({(b, *c) for c in calls for b in (1, 16, 32)})


def case_calls():
    out = []
    for b, h, w, g, gc, k, s, p, d, scale, _, _ in CASES.values():
        out.append((b, h, w, -(-h // s), -(-w // s), k, s, p, d, g, gc, scale))
    return out


@pytest.fixture(scope="module")
def calls():
    return {"config": config_calls(), "cases": case_calls()}


def zero_offset_corners(b, ho, wo, kernel, stride, pad, dilation, group, offset_scale):
    """Unpadded rows and columns (y0, x0) of the top-left corners of every
    zero-offset sample, (ho, wo, kk) each, from the plain coordinates."""
    offset = torch.zeros(1, ho, wo, group * kernel * kernel * 2)
    sx, sy = dcnv3_coords(offset, kernel, stride, pad, dilation, group, offset_scale)
    shape = (group, ho, wo, kernel * kernel)
    return (np.floor(sy.numpy()).reshape(shape)[0] - pad,
            np.floor(sx.numpy()).reshape(shape)[0] - pad)


@pytest.mark.parametrize("source", ["config", "cases"])
@pytest.mark.parametrize("backward", [False, True])
def test_plan_fits_shared_memory_and_window_covers_footprint(calls, source, backward):
    for b, h, w, ho, wo, k, s, p, d, g, gc, scale in calls[source]:
        plan = dcnv3_plan(b, ho, wo, g, gc, k, s, p, d, scale, backward)
        assert plan.shared_bytes <= SHARED_BYTES, plan
        assert 1 <= plan.cc <= CHUNK[backward]
        n_chunks = -(-gc // plan.cc)
        assert plan.cpb == n_chunks if backward else plan.cpb in (1, n_chunks)
        assert plan.blocks == b * g * -(-ho // plan.th) * -(-wo // plan.tw) \
            * -(-n_chunks // plan.cpb)
        y0, x0 = zero_offset_corners(b, ho, wo, k, s, p, d, g, scale)
        # each output pixel's window, from its tile's origin
        oy = np.arange(ho)[:, None, None]
        ox = np.arange(wo)[None, :, None]
        wy0 = oy // plan.th * plan.th * s + plan.win_off
        wx0 = ox // plan.tw * plan.tw * s + plan.win_off
        assert (y0 >= wy0).all() and (y0 + 1 < wy0 + plan.wh).all(), (b, h, w, k, s, plan)
        assert (x0 >= wx0).all() and (x0 + 1 < wx0 + plan.ww).all(), (b, h, w, k, s, plan)


def test_plan_fills_the_card_on_the_training_shapes(calls):
    """At bs 16 and 32 every call gets at least two blocks an SM, and room for
    four at once."""
    for b, h, w, ho, wo, k, s, p, d, g, gc, scale in calls["config"]:
        for backward in (False, True):
            plan = dcnv3_plan(b, ho, wo, g, gc, k, s, p, d, scale, backward)
            if b >= 16:
                assert plan.blocks >= 2 * SMS and blocks_per_sm(plan.shared_bytes) >= 4, plan


def test_plan_is_cached_and_refuses_what_no_plan_fits():
    a = dcnv3_plan(16, 80, 80, 1, 64, 3, 1, 1, 1, 1.0, True)
    assert dcnv3_plan(16, 80, 80, 1, 64, 3, 1, 1, 1, 1.0, True) is a
    with pytest.raises(ValueError, match="no launch plan"):
        dcnv3_plan(1, 8, 8, 1, 64, 31, 16, 15, 1, 1.0, True)


@pytest.mark.parametrize("backward", [False, True])
def test_window_escapes(backward):
    """The share of samples with a corner outside their window: none at zero
    offset or at an offset of exactly the margin R (the corner on the window's
    edge), some at R + 1 px (tile-edge pixels' outer taps), all at 1e4 px."""
    plan = dcnv3_plan(2, 12, 12, 1, 8, 3, 1, 1, 1, 1.0, backward)

    def share(dx):
        offset = torch.zeros(2, 12, 12, 18)
        offset[..., 0::2] = dx
        return dcnv3_window_escapes(offset, 12, 12, 3, 1, 1, 1, 1, 1.0, plan)
    assert share(0.0) == 0.0 and share(-WINDOW_MARGIN) == 0.0
    assert 0.0 < share(-WINDOW_MARGIN - 1) < 1.0
    assert share(1e4) == 1.0


def test_kernels_are_bound_once(monkeypatch):
    """The wrapper binds each launch function's ctypes signature once, outside
    the build's locks: 4 (forward) or 7 (backward) pointers, 13 ints (the
    shapes, the geometry and the output-row origin row0), the offset scale,
    the plan's 7 ints and the stream."""
    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            for n in ("dcnv3_sampling_launch", "dcnv3_backward_launch", "dcnv3_error_string",
                      "dcnv3_backward_error_string"):
                setattr(self, n, Fn())
    loads = []
    monkeypatch.setattr(build, "load_library", lambda name: loads.append(name) or Lib())
    monkeypatch.setattr(dcn_sampling, "_BOUND", {})
    for fn, n_ptr in (("dcnv3_sampling_launch", 4), ("dcnv3_backward_launch", 7)):
        launch, _ = dcn_sampling._bind(fn)
        assert len(launch.argtypes) == n_ptr + 13 + 1 + 7 + 1
        assert dcn_sampling._BOUND[fn][0] is launch
    assert loads == ["dcnv3", "dcnv3_bwd"]


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """An edit to csrc/dcnv3_common.cuh, which both DCNv3 sources include,
    changes both libraries' paths and so rebuilds them; the letterbox's does not
    move."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in ("dcnv3", "dcnv3_bwd", "letterbox")}
    header = csrc / "dcnv3_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    assert after["dcnv3"] != before["dcnv3"] and after["dcnv3_bwd"] != before["dcnv3_bwd"]
    assert after["letterbox"] == before["letterbox"]
