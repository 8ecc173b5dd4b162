"""The port's CUDA kernels on the card: each kernel against its plain torch
version, over the options and shapes the main path does not reach, and the
wrappers' refusals. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it runs on a GPU machine
that has neither; tests/conftest.py imports JAX, hence:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: 1e-5 absolute on values of order 1, the limit chip_smoke.py holds
the kernels to; the kernel and the plain version sum in other orders. The
backward kernel is held to 1e-5 relative to the largest magnitude of each
gradient: dx is summed in fixed point (exactly, up to terms below 2^-45 of the
largest) and doffset over the group's channels, where the plain version adds
in float32. Two calls of a kernel on the same inputs give the same bits, and a
bfloat16 call the float32 call's outputs on float32 copies, rounded.
"""

import os

import numpy as np
import pytest
import torch

from yolo_dual_tpu_torch.kernels.dcn_sampling import (
    WINDOW_MARGIN, dcnv3_core, dcnv3_core_bwd, dcnv3_sampling, dcnv3_sampling_backward)
from yolo_dual_tpu_torch.kernels.preprocess import (
    LaunchParams, _launch, launch_record, letterbox_normalize, letterbox_normalize_reference,
    semantic_preprocess, semantic_preprocess_reference)

pytestmark = pytest.mark.cuda
# cuBLAS takes a fixed workspace, read at its first use, for the deterministic test below
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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


@pytest.mark.parametrize("name", ["multi_tile_80", "ragged_37x53", "stride2",
                                  "window_edge_stride2_g2", "dilation2_k5"])
def test_dcnv3_kernels_on_a_band_of_rows_match_plain(cuda, name):
    """A space rank's calls (parallel/spatial.py): K2 and K3 on each of two
    bands of output rows (row0 0 and ho // 2), sampled in the whole x, against
    the plain versions on the band, and the forward against the whole map's
    rows."""
    b, h, w, g, gc, k, s, p, d, scale, std, kind = CASES[name]
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(len(name), b, h, w, g, gc, k, s, std, kind))
    ho = offset.shape[1]
    gout = torch.randn((b, ho, offset.shape[2], g * gc), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(len(name)))
    cfg = (k, s, p, d, g, gc, scale)
    whole = dcnv3_core(x, offset, mask, *cfg)
    for r0, r1 in ((0, ho // 2), (ho // 2, ho)):
        band = [t[:, r0:r1].contiguous() for t in (offset, mask, gout)]
        got = dcnv3_sampling(x, band[0], band[1], *cfg, r0)
        want = dcnv3_core(x, band[0], band[1], *cfg, r0)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5
        assert (got - whole[:, r0:r1]).abs().max().item() <= 1e-5
        assert_grads_close(dcnv3_sampling_backward(x, *band, *cfg, r0),
                           dcnv3_core_bwd(x, *band, *cfg, r0))


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


@pytest.mark.parametrize("offset_std, row0", [(2.0, 0), (8.0, 0), (8.0, 40)],
                         ids=["normal", "escaping", "escaping_band"])
def test_dcnv3_backward_is_bitwise_stable(cuda, offset_std, row0):
    """Two calls on the same inputs give the same bits of dx, doffset and
    dmask: doffset and dmask are reduced in a fixed order (one owner warp per
    sum, chunks in order), dx in fixed point, whose integer adds give one sum
    in any order. Also where many samples leave their window (offsets N(0, 8
    px)) and on a band of rows (row0 40), and against the plain version."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_plan, dcnv3_window_escapes
    x, offset, mask = (torch.from_numpy(a).to(cuda) for a in
                       sampling_inputs(7, 2, 80, 80, 1, 64, 3, offset_std=offset_std))
    offset, mask = offset[:, row0:].contiguous(), mask[:, row0:].contiguous()
    gout = torch.randn(2, 80 - row0, 80, 64, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(7))
    args = (3, 1, 1, 1, 1, 64, 1.0, row0)
    first = dcnv3_sampling_backward(x, offset, mask, gout, *args)
    second = dcnv3_sampling_backward(x, offset, mask, gout, *args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert_grads_close(first, dcnv3_core_bwd(x, offset, mask, gout, *args))
    plan = dcnv3_plan(2, 80 - row0, 80, 1, 64, 3, 1, 1, 1, 1.0, True)
    escapes = dcnv3_window_escapes(offset, 80, 80, 3, 1, 1, 1, 1, 1.0, plan, row0)
    assert escapes > (0.3 if offset_std > 2 else 0.0), escapes


@pytest.mark.parametrize("name", sorted(CASES))
def test_dcnv3_kernels_in_bfloat16_equal_float32_rounded(cuda, name):
    """K2 and K3 on bfloat16 inputs against the float32 kernels on float32
    copies of the same values: every output is the float32 one rounded to
    bfloat16, bit for bit, and in its input's type."""
    b, h, w, g, gc, k, s, p, d, scale, std, kind = CASES[name]
    x, offset, mask = (torch.from_numpy(a).to(cuda).bfloat16() for a in
                       sampling_inputs(len(name), b, h, w, g, gc, k, s, std, kind))
    gout = torch.randn((b, *offset.shape[1:3], g * gc), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(len(name))).bfloat16()
    cfg = (k, s, p, d, g, gc, scale)
    with torch.no_grad():
        got = dcnv3_sampling(x, offset, mask, *cfg)
        want = dcnv3_sampling(x.float(), offset.float(), mask.float(), *cfg)
    got_b = dcnv3_sampling_backward(x, offset, mask, gout, *cfg)
    want_b = dcnv3_sampling_backward(x.float(), offset.float(), mask.float(), gout.float(), *cfg)
    torch.cuda.synchronize()
    for a, r in zip((got, *got_b), (want, *want_b)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, r.bfloat16())


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
        dcnv3_sampling(x.half(), offset.half(), mask.half(), 3, 1, 1, 1, 1, 8, 1.0)
    with pytest.raises(TypeError, match="one type"):
        dcnv3_sampling(x.bfloat16(), offset, mask, 3, 1, 1, 1, 1, 8, 1.0)


def frames(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))


LETTERBOX_CASES = {  # name: ((B, H, W), S, fill, scaleup)
    "1080p_exact_3to1": ((1, 1080, 1920), 640, 114.0, True),
    "720p_exact_2to1": ((1, 720, 1280), 640, 114.0, True),
    "odd_333x1137": ((1, 333, 1137), 320, 114.0, True),  # row stride 3411 bytes
    "portrait_odd_left": ((1, 1137, 333), 320, 114.0, True),  # left 113
    "s102": ((1, 40, 30), 102, 114.0, True),  # S % 4 != 0: scalar stores
    "frame_1x1": ((1, 1, 1), 64, 114.0, True),
    "frame_2x3": ((1, 2, 3), 64, 114.0, True),
    "upscale_8x": ((1, 80, 80), 640, 114.0, True),
    "no_scaleup_inside_a_block": ((1, 3, 7), 640, 114.0, False),
    "no_scaleup_480p_bs3": ((3, 480, 640), 640, 114.0, False),
    "fill0": ((1, 100, 150), 160, 0.0, True),
    "fill128": ((1, 100, 150), 160, 128.0, True),
    "fill255": ((1, 100, 150), 160, 255.0, True),
    "batch5": ((5, 360, 480), 320, 114.0, True),
    "4k": ((1, 2160, 3840), 640, 114.0, True),
    "8k_wide": ((1, 2160, 7680), 640, 114.0, True),
}


def letterbox_with(both, x, s, fill=114.0, scaleup=True):
    """The letterbox of x through the public wrapper, or, where the wrapper
    takes the other variant of the kernel (`both`: read both taps of every row
    and column without a branch), through that variant."""
    rec = launch_record(*x.shape[1:3], s, fill, scaleup, x.device)
    if rec.params.both == both:
        return letterbox_normalize(x, s, fill, scaleup)
    params = LaunchParams.from_buffer_copy(rec.params)
    params.both = both
    out = torch.empty((x.shape[0], 3, s, s), device=x.device)
    _launch(x, out, params)
    return out


@pytest.mark.parametrize("both", [0, 1])
@pytest.mark.parametrize("name", sorted(LETTERBOX_CASES))
def test_letterbox_kernel_matches_plain(cuda, name, both):
    (b, h, w), s, fill, scaleup = LETTERBOX_CASES[name]
    x = frames(len(name), b, h, w).to(cuda)
    want = letterbox_normalize_reference(x, s, fill, scaleup)
    before = letterbox_normalize.launches
    got = letterbox_with(both, x, s, fill, scaleup)
    torch.cuda.synchronize()
    public = launch_record(h, w, s, fill, scaleup, x.device).params.both == both
    assert letterbox_normalize.launches == before + public
    assert got.shape == want.shape == (b, 3, s, s) and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("both", [0, 1])
def test_letterbox_over_a_sweep_of_sizes(cuda, both):
    """Frames of 1 to 239 rows and as many or twice as many columns, onto
    canvases that are and are not multiples of 4: the taps, the pads and the
    content box's edges of each."""
    for h, w in ((h, w) for h in range(1, 241, 7) for w in (h, 2 * h + 1, max(h // 2, 1))):
        x = frames(h * w, 1, h, w).to(cuda)
        for s in (96, 102):
            got = letterbox_with(both, x, s)
            assert (got - letterbox_normalize_reference(x, s)).abs().max().item() <= 1e-5, \
                (h, w, s)


def test_letterbox_on_a_side_stream(cuda):
    x = frames(1, 2, 720, 1280).to(cuda)
    want = letterbox_normalize_reference(x, 640)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = letterbox_normalize(x, 640)
    stream.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("b", [1, 2])
def test_letterbox_replays_in_a_cuda_graph(cuda, b):
    """After one warm-up call a call captures into a CUDA graph; a replay on
    a new frame copied into the static input equals an eager call."""
    static = frames(2, b, 1080, 1920).to(cuda)
    letterbox_normalize(static, 640)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = letterbox_normalize(static, 640)
    new = frames(3, b, 1080, 1920).to(cuda)
    static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, letterbox_normalize(new, 640))
    assert (out - letterbox_normalize_reference(new, 640)).abs().max().item() <= 1e-5


def test_letterbox_graph_replays_after_many_other_geometries(cuda):
    """The launch record a graph captured stays alive while 65 other
    geometries are built and their calls allocate and free memory."""
    static = frames(5, 1, 720, 1280).to(cuda)
    letterbox_normalize(static, 640)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = letterbox_normalize(static, 640)
    for k in range(65):
        letterbox_normalize(frames(k, 1, 16 + k, 24).to(cuda), 64)
    new = frames(6, 1, 720, 1280).to(cuda)
    static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert (out - letterbox_normalize_reference(new, 640)).abs().max().item() <= 1e-5


def test_letterbox_rejects_what_the_kernel_does_not_take(cuda):
    x = frames(4, 1, 48, 64).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        letterbox_normalize(x.transpose(1, 2), 64)
    with pytest.raises(TypeError, match="uint8"):
        letterbox_normalize(x.float(), 64)


# -- the evaluation slice on the card ------------------------------------------

SMALL_SEG = dict(  # tests/test_eval_dp.py's TINY_SEG: 64 px, nc 3, nm 4
    nc=3, depth_multiple=1.0, width_multiple=1.0,
    anchors=[[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
    backbone=[[-1, 1, "Conv", [8, 6, 2, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "C3", [16]],
              [-1, 1, "Conv", [24, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
    head=[[[3, 4], 1, "Segment", ["nc", "anchors", 4, 8]]],
)


def small_eval_model():
    """SMALL_SEG on the CPU with seeded BatchNorm statistics (so scores
    spread) and the JAX dryrun's priming (+3 objectness, +1 class, +2
    coefficient biases, +2 on the proto cv3 BN bias: solid masks)."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    gen = torch.Generator().manual_seed(3)
    model = SegmentationModel(SMALL_SEG, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)
                m.running_mean.normal_(0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        head = model.model[-1]
        for conv in head.m:
            b = conv.bias.view(head.na, -1)
            b[:, 4] += 3.0
            b[:, 5:5 + head.nc] += 1.0
            b[:, 5 + head.nc:] += 2.0
        head.proto.cv3.bn.bias += 2.0
    return model.eval()


def self_labelled_raw_batches(model, n_batches=3, bs=4, h=48, w=64, s=64):
    """image_raw batches whose gt (boxes wider and taller than 2 px, up to 4
    an image, with their masks as overlap planes) is the model's own."""
    from yolo_dual_tpu_torch.ops.mask_ops import process_mask
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    rng = np.random.default_rng(0)
    head = model.model[-1]
    batches = []
    for _ in range(n_batches):
        frames_ = rng.integers(0, 256, (bs, h, w, 3), dtype=np.uint8)
        with torch.no_grad():
            levels, protos = model(letterbox_normalize(torch.from_numpy(frames_), s,
                                                       scaleup=False), decode=False)
            out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=1e-4,
                                   iou_thres=0.6, max_det=50, nm=head.nm)
        targets = np.zeros((bs, 6, 5), np.float32)
        tmask = np.zeros((bs, 6), bool)
        masks = np.zeros((bs, s // 4, s // 4), np.float32)
        for b in range(bs):
            d = out[b, :int(nv[b])]
            d = d[((d[:, 2] - d[:, 0]) > 2) & ((d[:, 3] - d[:, 1]) > 2)][:4]
            pm = process_mask(protos[b], d[:, 6:], d[:, :4], (s, s)).numpy()
            for j, dd in enumerate(d.numpy()):
                x1, y1, x2, y2 = np.clip(dd[:4], 0, s) / s
                targets[b, j] = [dd[5], (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]
                tmask[b, j] = True
                masks[b][pm[j]] = j + 1
        batches.append({"image_raw": frames_, "targets": targets, "tmask": tmask,
                        "masks": masks, "n_valid": np.int32(bs)})
    return batches


class _Loader(list):
    dataset = type("DS", (), {"imgsz": 64, "im_files": None})()


def test_evaluate_segment_launches_k1_per_batch_and_equals_cpu(cuda):
    """The validator's image_raw route letterboxes each batch with one K1
    launch, and its 8 metrics and per-class maps equal the CPU run's (TF32
    off: in TF32 the protos move by ~1e-3 and flip mask pixels at 0.5)."""
    import copy

    from yolo_dual_tpu_torch.engine.validator import evaluate_segment
    model = small_eval_model()
    loader = _Loader(self_labelled_raw_batches(model))
    want, want_maps, _ = evaluate_segment(copy.deepcopy(model), loader, 3, nm=4, device="cpu")
    letterbox_normalize.launches = 0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, got_maps, _ = evaluate_segment(model, loader, 3, nm=4, device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert letterbox_normalize.launches == len(loader) == 3
    assert want[2] > 0.05 and want[6] > 0.05, want
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)


@pytest.mark.parametrize("multi_label", [False, True])
def test_nms_from_raw_on_tied_scores_equals_cpu(cuda, multi_label):
    """Half the cells at objectness and class-0 logit 30: ~3,150 candidates
    tie at conf 1.0, and the card keeps the CPU's rows (lower index first)."""
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    anchors = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
    rng = np.random.default_rng(0)
    raw = []
    for s in (8, 16, 32):
        r = rng.normal(0, 1, (2, 3, 320 // s, 320 // s, 117)).astype(np.float32)
        hot = rng.uniform(size=r.shape[:4]) < 0.5
        r[..., 4][hot] = 30
        r[..., 5][hot] = 30
        raw.append(torch.from_numpy(r))
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, nm=32, pre_nms_topk=1024,
              multi_label=multi_label)
    want, want_n = nms_from_raw(raw, anchors, (8, 16, 32), **kw)
    got, got_n = nms_from_raw([r.to(cuda) for r in raw], anchors, (8, 16, 32), **kw)
    assert got_n.tolist() == want_n.tolist() == [300, 300]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-5)


def test_dcnv3_under_autocast_samples_bfloat16(cuda, monkeypatch):
    """Under torch.autocast (the train CLI's --dtype bf16) DCNv3's projections
    are bfloat16 and go to K2 and K3 as they are (JAX nn/dcn.py:388-399): each
    kernel launches once, on bfloat16, and the output and every parameter's
    gradient equal, bit for bit, those of the route that hands the kernels
    float32 copies and rounds the output to bfloat16. Against the float32
    module: 5e-2 of the output's largest magnitude (bfloat16's 8 bits through
    two projections)."""
    import yolo_dual_tpu_torch.nn.dcn as dcn
    from yolo_dual_tpu_torch.nn.dcn import DCNv3
    torch.manual_seed(0)
    m = DCNv3(64, group=4).to(cuda)
    with torch.no_grad():
        m.offset.weight.normal_(0, 0.05)
        m.offset.bias.normal_(0, 1.0)
    x = torch.randn(2, 20, 20, 64, device=cuda)
    real, seen = dcn.dcnv3_sampling, []

    def run(sampling):
        monkeypatch.setattr(dcn, "dcnv3_sampling", sampling)
        m.zero_grad()
        before = (dcnv3_sampling.launches, dcnv3_sampling_backward.launches)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = m(x)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert (dcnv3_sampling.launches, dcnv3_sampling_backward.launches) == \
            (before[0] + 1, before[1] + 1)
        return [out.detach()] + [p.grad.clone() for p in m.parameters()]

    def direct(proj, offset, mask, *cfg):
        seen.append((proj.dtype, offset.dtype, mask.dtype))
        return real(proj, offset, mask, *cfg)

    def float_copies(proj, offset, mask, *cfg):
        return real(proj.float(), offset.float(), mask.float(), *cfg).to(proj.dtype)
    got, want = run(direct), run(float_copies)
    assert seen == [(torch.bfloat16,) * 3] and got[0].dtype == torch.bfloat16
    assert all(torch.isfinite(t).all() for t in got)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    monkeypatch.setattr(dcn, "dcnv3_sampling", real)
    with torch.no_grad():
        full = m(x)
    assert (got[0].float() - full).abs().max() <= 5e-2 * full.abs().max()


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "ones_mask"])
def test_deform_conv2d_v2_on_the_card_equals_cpu(cuda, with_mask):
    """DCNv2's deformable conv (torch ops: JAX's is lax, no Pallas kernel)
    on the card against the CPU, offsets of up to ±3 px past the border, with
    a mask and with C2f_DCN's all-ones one: the output and every gradient
    within 1e-5 of its largest magnitude (dx sums by index_add_, float atomics
    on the card)."""
    from yolo_dual_tpu_torch.nn.dcn import deform_conv2d_v2
    gen = torch.Generator().manual_seed(0)
    b, c, h, w, co = 2, 32, 20, 24, 16
    x = torch.randn(b, c, h, w, generator=gen)
    off = torch.rand(b, 18, h, w, generator=gen) * 6 - 3
    mask = torch.rand(b, 9, h, w, generator=gen) if with_mask else None
    weight = torch.randn(co, c, 3, 3, generator=gen) / 17
    bias = torch.randn(co, generator=gen)

    def run(dev):
        ins = [t.to(dev).requires_grad_(True) if t is not None else None
               for t in (x, off, mask, weight, bias)]
        out = deform_conv2d_v2(*ins, 1, 1, 1, 1, 1)
        (out * torch.linspace(-1, 1, out.numel(), device=dev).view(out.shape)).sum().backward()
        return [out.detach()] + [t.grad for t in ins if t is not None]
    for got, want in zip(run(cuda), run("cpu")):
        assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms(True), strict, and cuDNN's
    deterministic algorithms without TF32; the settings restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved[1:]


@pytest.mark.parametrize("shape,size,align_corners,antialias", [
    ((48, 48), (96, 96), False, True), ((41, 37), (20, 19), False, True),
    ((17, 23), (40, 40), True, False)])
def test_resize_backward_under_deterministic_algorithms(cuda, deterministic, shape, size,
                                                        align_corners, antialias):
    """The semantic resizes (common.interpolate_bilinear) under deterministic
    algorithms on the card: the forward equals F.interpolate's on the CPU and
    the gradient, two matrix products instead of CUDA's atomics, is within
    1e-5 of the CPU's and the same in two runs."""
    import torch.nn.functional as F
    from yolo_dual_tpu_torch.nn.common import interpolate_bilinear
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, *shape, generator=gen)
    g = torch.randn(2, 3, *size, generator=gen)

    def run(dev, fn):
        xr = x.to(dev, copy=True).requires_grad_(True)
        out = fn(xr, size, align_corners=align_corners, antialias=antialias)
        out.backward(g.to(dev))
        return out.detach().cpu(), xr.grad.cpu()
    cpu = run("cpu", lambda t, s, **k: F.interpolate(t, size=s, mode="bilinear", **k))
    first, second = run(cuda, interpolate_bilinear), run(cuda, interpolate_bilinear)
    assert torch.equal(first[1], second[1])
    for got, want in zip(first, cpu):
        assert (got - want).abs().max() <= 1e-5


def test_dcnv3_seg_backward_is_deterministic_on_the_card(cuda, deterministic):
    """yolov5s-seg-dcnv3 in train mode under deterministic algorithms, its
    DCNv3 offset heads drawn so that samples leave their windows: two runs of
    the forward and backward (K2 and K3 six times each) give bit-identical,
    finite gradients, as JAX's deterministic kernels give."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.nn.dcn import DCNv3
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(0))

    def grads():
        model = SegmentationModel("yolov5s-seg-dcnv3.json", device=cuda)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, DCNv3):
                    m.offset.weight.copy_(torch.randn(m.offset.weight.shape, generator=gen) * 0.05)
                    m.offset.bias.copy_(torch.randn(m.offset.bias.shape, generator=gen) * 2.0)
        model.train()
        before = (dcnv3_sampling.launches, dcnv3_sampling_backward.launches)
        levels, protos = model(x.to(cuda))  # train mode: the raw level maps and the protos
        loss = sum((t * torch.linspace(-1, 1, t.numel(), device=cuda).view(t.shape)).sum()
                   for t in (*levels, protos))
        loss.backward()
        torch.cuda.synchronize()
        assert (dcnv3_sampling.launches, dcnv3_sampling_backward.launches) == \
            (before[0] + 6, before[1] + 6)
        return [p.grad.cpu() for p in model.parameters() if p.grad is not None]
    first, second = grads(), grads()
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("cfg", ["resnet50.json", "yolov5_seg.json"])
def test_semantic_backward_is_deterministic_on_the_card(cuda, deterministic, cfg):
    """Under deterministic algorithms a semantic model's forward and backward
    run on the card (no op refuses: the output resize goes through
    common._DeterministicResize, DCNv2's index_add_ through torch's
    deterministic variant) and two runs give bit-identical, finite gradients:
    the learning proofs of chip_smoke.py run so."""
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))

    def grads():
        model = SemanticSegModel(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
        model.train()
        out = model(x.to(cuda))
        (out * torch.linspace(-1, 1, out.numel(), device=cuda).view(out.shape)).sum().backward()
        return [p.grad.cpu() for p in model.parameters() if p.grad is not None]  # dead rows: None
    first, second = grads(), grads()
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_mosaic_warp_hsv_on_the_card_equals_cpu(cuda):
    """The device augmentation's torch ops on the card against the same ops
    on the CPU, 1e-4 after /255 (chip_smoke.py phase 10's tolerance)."""
    import random
    from yolo_dual_tpu_torch.data.augment import sample_perspective_matrix
    from yolo_dual_tpu_torch.kernels.augment import mosaic_warp_hsv
    rng = np.random.default_rng(0)
    B, s = 3, 128
    tiles = rng.integers(0, 256, (B, 4, s, s, 3), dtype=np.uint8)
    xc, yc = s, s
    dst = np.tile(np.array([[0, 0, xc, yc], [xc, 0, 2 * s, yc], [0, yc, xc, 2 * s],
                            [xc, yc, 2 * s, 2 * s]], np.float32), (B, 1, 1))
    off = np.tile(np.array([[0, 0], [-xc, 0], [0, -yc], [-xc, -yc]], np.float32), (B, 1, 1))
    inv = np.stack([np.linalg.inv(sample_perspective_matrix(
        (2 * s, 2 * s), degrees=10, translate=0.1, scale=0.5, shear=5, perspective=1e-3,
        border=(-s // 2, -s // 2), rng=random.Random(b))[0]) for b in range(B)]).astype(np.float32)
    gains = (rng.uniform(-1, 1, (B, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32)
    flips = np.array([[0, 0], [1, 0], [1, 1]], bool)
    args = [torch.from_numpy(a) for a in (tiles, dst, off, inv, gains, flips)]
    want = mosaic_warp_hsv(*args, out_size=s)
    got = mosaic_warp_hsv(*(a.to(cuda) for a in args), out_size=s)
    assert got.device.type == "cuda"
    assert (got.cpu() - want).abs().max().item() <= 1e-4


SEMANTIC_CASES = {  # name: (b, h, w, out_size, augment)
    "camvid_720x960_to_640": (4, 720, 960, 640, True),
    "camvid_720x960_to_640_plain": (2, 720, 960, 640, False),
    "odd_45x67_to_64": (3, 45, 67, 64, True),
    "portrait_70x37_to_64": (2, 70, 37, 64, True),
}


@pytest.mark.parametrize("name", sorted(SEMANTIC_CASES))
def test_semantic_preprocess_k1_matches_plain(cuda, name):
    """semantic_preprocess on the card (K1 at fill 128, one launch, then the
    mask gathers, flip, brightness and contrast) against its plain version
    on the same card: the mask exact, the image within K1's 1e-5."""
    b, h, w, s, augment = SEMANTIC_CASES[name]
    rng = np.random.default_rng(h * w + b)
    im = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(cuda)
    mk = torch.from_numpy(rng.integers(0, 12, (b, h, w)).astype(np.int32)).to(cuda)
    aug = dict(flip=torch.from_numpy(np.arange(b) % 2 == 0).to(cuda),
               bright=torch.from_numpy(rng.uniform(0.8, 1.2, b).astype(np.float32)).to(cuda),
               contr=torch.from_numpy(rng.uniform(0.8, 1.2, b).astype(np.float32)).to(cuda)) \
        if augment else {}
    want_im, want_mk = semantic_preprocess_reference(im, mk, s, **aug)
    before = letterbox_normalize.launches
    got_im, got_mk = semantic_preprocess(im, mk, s, **aug)
    torch.cuda.synchronize()
    assert letterbox_normalize.launches == before + 1
    assert got_im.shape == (b, 3, s, s) and got_mk.shape == (b, s, s)
    assert got_mk.dtype == torch.int32 and torch.equal(got_mk, want_mk)
    assert (got_im - want_im).abs().max().item() <= 1e-5


def narrow_resnet18(div: int = 8) -> dict:
    """The port's resnet18.json with every width but the class count divided
    by `div` (the SegmentHead's at least 2), as tests/torch_port_common.py
    narrows the JAX yaml; built here from the JSON copy, since the card's
    machine has no PyYAML."""
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    d = load_config(find_cfg("resnet18.json"))
    for row in d["backbone"] + d["head"]:
        args = row[3]
        if row[2] == "SegmentHead":
            args[1] = max(args[1] // div, 2)
        elif row[2] not in ("nn.Softmax", "Concat", "Upsample") and args[0] != d["nc"]:
            args[0] = max(args[0] // div, 4)
    return d


def test_semantic_train_step_on_the_card_equals_cpu(cuda):
    """One semantic train step (past warmup, so every group moves) of a
    narrow ResNet18 from the same weights on the card and on the CPU, TF32
    off: loss items within 1e-4 relative, every parameter's update within
    1e-2 of its largest magnitude, the BatchNorm statistics within 1e-4 of
    theirs (the step's float32 gradients carry the card's other summation
    orders; the statistics are one batch's moments)."""
    from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import Trainer
    cfg = narrow_resnet18()
    rng = np.random.default_rng(3)
    mask = rng.integers(0, 12, (2, 96, 96)).astype(np.int32)
    image = np.clip(rng.integers(0, 256, (12, 3))[mask] + rng.integers(-30, 31, (2, 96, 96, 3)),
                    0, 255).astype(np.uint8)
    batch = {"image": image, "mask": mask}
    start = SemanticSegModel(cfg, device="cpu").state_dict()
    runs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = SemanticSegModel(cfg, device=dev)
            model.load_state_dict(start)
            opt = smart_optimizer(model, "SGD", {}, epochs=10, steps_per_epoch=3,
                                  total_batch_size=2)
            opt.count = 100
            trainer = Trainer(model, SemanticSegLoss(12), opt, ModelEMA(model), task="semantic")
            state, metrics = trainer.train_step(trainer.init_state(), batch)
            runs[dev] = (metrics["items"].cpu(), {k: v.cpu() for k, v in model.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (ci, cs), (gi, gs) = runs["cpu"], runs["cuda"]
    torch.testing.assert_close(gi, ci, rtol=1e-4, atol=1e-6)
    names = dict(SemanticSegModel(cfg, device="cpu").named_parameters())
    for k, v in cs.items():
        if k in names:
            d_cpu, d_card = v - start[k], gs[k] - start[k]
            assert (d_card - d_cpu).abs().max() <= 1e-2 * d_cpu.abs().max() + 1e-8, k
        elif v.is_floating_point():
            assert (gs[k] - v).abs().max() <= 1e-4 * v.abs().max(), k


def test_semantic_train_cli_launches_k1_per_device_route_batch(cuda, tmp_path):
    """semantic.train on the card: with --device-preprocess K1 fits every
    training batch (one launch each; the val pass is the host route's), on
    the host route it never launches; both write finite results."""
    import json

    from yolo_dual_tpu_torch.semantic import train as cli
    rng = np.random.default_rng(5)
    (tmp_path / "images").mkdir()
    (tmp_path / "json").mkdir()
    for i in range(9):
        mask = rng.integers(0, 12, (45, 60)).astype(np.uint8)
        np.save(tmp_path / "images" / f"f{i}.npy",
                rng.integers(0, 256, (45, 60, 3), dtype=np.uint8))
        (tmp_path / "json" / f"f{i}.json").write_text(json.dumps(
            {"filename": f"f{i}.png", "shape": [45, 60], "dtype": "uint8", "class_names": [],
             "mask_data": mask.reshape(-1).tolist()}))
    (tmp_path / "narrow.json").write_text(json.dumps(narrow_resnet18()))
    for route, flags, launches in (("device", ["--device-preprocess"], 2 * 2), ("host", [], 0)):
        letterbox_normalize.launches = 0
        cli.main(["--cfg", str(tmp_path / "narrow.json"), "--img-dir", str(tmp_path / "images"),
                  "--json-dir", str(tmp_path / "json"), "--imgsz", "64", "--batch-size", "4",
                  "--epochs", "2", "--nbs", "8", "--project", str(tmp_path / "runs"),
                  "--name", route, "--device", "cuda"] + flags)
        torch.cuda.synchronize()
        assert letterbox_normalize.launches == launches, route
        rows = (tmp_path / "runs" / route / "results.csv").read_text().splitlines()[1:]
        assert len(rows) == 2 and np.isfinite([float(v) for r in rows for v in r.split(",")]).all()


@pytest.mark.parametrize("name", ["yolov5s.yaml", "convnext_tiny"])
def test_classify_forward_on_the_card_equals_cpu(cuda, name):
    """A classifier of classify.train (yolov5s-cls, cutoff 10; convnext_tiny's
    three stages) at nc 1000 and 224 px from JAX's initial weights, its
    BatchNorm statistics set by a train-mode pass over the batch: eval-mode
    logits on the card within 1e-4 of their largest magnitude of the CPU's,
    TF32 off."""
    from yolo_dual_tpu_torch.classify.train import build_classifier
    from yolo_dual_tpu_torch.models.flax_init import flax_init_
    torch.backends.cudnn.allow_tf32 = False
    model = flax_init_(build_classifier(name, 1000, device="cpu"))
    x = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(0))
    for bn in model.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.momentum = None  # a cumulative average: one batch sets its own statistics
    with torch.no_grad():
        model.train()(x)
        want = model.eval()(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    torch.backends.cudnn.allow_tf32 = True
    assert got.shape == (4, 1000)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


class _FileLoader(list):
    """Batches with `index` and `shape0`, and the file names --save-json reads."""
    dataset = type("DS", (), {"imgsz": 64, "im_files": [f"{100 + i}.jpg" for i in range(12)]})()


def test_evaluate_segment_save_json_on_the_card_equals_cpu(cuda, tmp_path):
    """evaluate_segment(save_json=True) on the card and on the CPU (TF32
    off): the same entries, bbox within 1e-3 px (plus JSON's rounding), and
    the masks, resized on each device in cv2's float32 arithmetic, equal but
    for flips at proto values within float32 rounding of 0.5 (at most 1e-3 of
    the pixels)."""
    import copy
    import json

    from yolo_dual_tpu_torch.engine.validator import evaluate_segment
    from yolo_dual_tpu_torch.utils.coco import rle_to_binary_mask
    model = small_eval_model()
    batches = self_labelled_raw_batches(model)
    for k, b in enumerate(batches):
        b["index"] = np.arange(4 * k, 4 * k + 4)
        b["shape0"] = np.array([(96, 128), (48, 64), (72, 96), (50, 66)], np.int32)
    loader = _FileLoader(batches)
    kw = dict(nm=4, max_det=40, save_json=True)
    evaluate_segment(copy.deepcopy(model), loader, 3, device="cpu", save_dir=str(tmp_path / "cpu"),
                     **kw)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        evaluate_segment(model, loader, 3, device="cuda", save_dir=str(tmp_path / "cuda"), **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want, got = (json.loads((tmp_path / d / "predictions.json").read_text())
                 for d in ("cpu", "cuda"))
    assert len(got) == len(want) > 20
    flips = pixels = 0
    for w, g in zip(sorted(want, key=lambda e: (e["image_id"], -e["score"])),
                    sorted(got, key=lambda e: (e["image_id"], -e["score"]))):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= 2e-5
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=2e-3)
        assert g["segmentation"]["size"] == w["segmentation"]["size"]
        gm, wm = (rle_to_binary_mask(e["segmentation"]) for e in (g, w))
        flips, pixels = flips + int((gm != wm).sum()), pixels + gm.size
    assert flips <= 1e-3 * pixels


def test_server_launches_k2_per_request_and_equals_cpu(cuda, tmp_path):
    """yolov5s-seg-dcnv3 (seeded weights, primed) served at 128 px on the card: 6 K2
    launches a request plus the warm-up's, no K1; each reply holds the CPU
    server's rows (TF32 off), boxes within 1e-2 px, confidences within 1e-4,
    near ties counted by detection_matching.pair_detections."""
    import threading

    from detection_matching import pair_detections
    from yolo_dual_tpu_torch import serve
    from yolo_dual_tpu_torch.io.remote import RemoteModel
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.utils import png
    gen = torch.Generator().manual_seed(5)
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cpu", generator=gen)
    with torch.no_grad():   # seeded BatchNorm statistics; objectness and class biases raised
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        head = model.model[-1]
        for conv in head.m:
            b = conv.bias.view(head.na, -1)
            b[:, 4] += 6.0
            b[:, 5:5 + head.nc] += 5.0
    torch.save(model.state_dict(), tmp_path / "w.pt")
    argv = ["--weights", str(tmp_path / "w.pt"), "--cfg", "yolov5s-seg-dcnv3.json",
            "--imgsz", "128", "--conf-thres", "0.25", "--port", "0"]
    rng = np.random.default_rng(1)
    bodies = [png.encode(rng.integers(0, 256, shape, dtype=np.uint8))
              for shape in ((96, 128, 3), (128, 80, 3), (60, 100, 3))]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    dcnv3_sampling.launches = letterbox_normalize.launches = 0
    servers = [serve.build_server(serve.parse_opt(argv + ["--device", d])) for d in ("cuda", "cpu")]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        card, cpu = (RemoteModel(f"http://127.0.0.1:{s.server_address[1]}", timeout=120)
                     for s in servers)
        for body in bodies:
            g, c = card(body), cpu(body)
            _, _, left_c, left_g = pair_detections(c, g, 0.25, box_tol=1e-2, conf_tol=1e-4)
            assert len(g) and not len(left_c) and not len(left_g)
        assert dcnv3_sampling.launches == 6 * (len(bodies) + 1)
        assert letterbox_normalize.launches == 0
        assert all("device_events_ms" in t for t in servers[0].timings)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for s, t in zip(servers, threads):
            s.shutdown()
            s.server_close()
            t.join(60)
