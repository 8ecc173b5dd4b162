"""The port's DCNv3 slice against the JAX package: the plain sampling core
against JAX's lax core and its Pallas kernel (interpret mode), the four DCNv3
modules, the compiler on yolov5s-seg-dcnv3, its full-width parameter tree, and
a nano DCNv3 model end to end (forward unfused and fused, and predict_images).

Inputs and weights are made with numpy from a seed and handed to both. JAX
matmuls run at "highest" precision, as tests/test_kernels.py pins them.
Tolerance: atol 1e-4 and rtol 1e-4 in float32, because the two frameworks sum
in different orders; in bfloat16 one bfloat16 ulp of each value against the
Pallas kernel (float32 sums in another order, then rounded), and bit for bit
between the DCNv3 module under CPU autocast and its float32-copy route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (CORE_CASES, bf16_ulp_gap, nhwc, random_variables,
                               sampling_inputs, to_bfloat16)
from yolo_dual_tpu.engine import predict_images as jax_predict_images
from yolo_dual_tpu.kernels.dcn_sampling import _dcnv3_banded_dispatch
from yolo_dual_tpu.models.compiler import parse_config as jax_parse_config
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.nn import dcn as JD
from yolo_dual_tpu_torch.engine.predictor import predict_images
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.kernels import build
from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_core, dcnv3_sampling
from yolo_dual_tpu_torch.models.compiler import parse_config
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.nn import dcn as PD
from detection_matching import match_detections
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

TOL = dict(rtol=1e-4, atol=1e-4)
DCN_ROWS = (4, 6, 8)  # the backbone rows yolov5n-DCN.yaml turns into C3_DCN


def highest():
    return jax.default_matmul_precision("highest")


def dcn_cfg(base: str) -> dict:
    """The port's JSON copy of `base` with backbone rows 4, 6 and 8 made C3_DCNV3."""
    d = load_config(find_cfg(base))
    for r in DCN_ROWS:
        d["backbone"][r][2] = "C3_DCNV3"
    return d


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_dcnv3_core_matches_jax(name):
    b, h, w, g, gc, k, s, p, d, scale, std = CORE_CASES[name]
    x, offset, mask = sampling_inputs(len(name), b, h, w, g, gc, k, s, std)
    want = np.asarray(JD.dcnv3_core(jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
                                    k, s, p, d, g, gc, scale))
    args = (torch.from_numpy(x), torch.from_numpy(offset), torch.from_numpy(mask),
            k, s, p, d, g, gc, scale)
    got = dcnv3_core(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(dcnv3_sampling(*args).numpy(), got.numpy())


def pallas_case(case):
    """(x, offset, mask, g, gc, k) of the Pallas kernel comparisons: "in_band",
    or "band_escape", whose Δy 15 on 24 rows leaves the kernel's 16-row band and
    takes its escape to the lax core."""
    if case == "in_band":
        b, h, w, g, gc, k = 1, 8, 8, 2, 4, 3
        return (*sampling_inputs(3, b, h, w, g, gc, k), g, gc, k)
    b, h, w, g, gc, k = 1, 24, 8, 1, 4, 3
    x = np.random.default_rng(4).standard_normal((b, h, w, g * gc)).astype(np.float32)
    offset = np.zeros((b, h, w, g * k * k * 2), np.float32)
    offset[..., 1::2] = 15.0
    mask = np.full((b, h, w, g * k * k), 1 / 9, np.float32)
    return x, offset, mask, g, gc, k


@pytest.mark.parametrize("case", ["in_band", "band_escape"])
def test_dcnv3_core_matches_pallas_kernel(case):
    """The plain core against the JAX package's Pallas kernel itself, run as
    its own tests run it (interpret mode)."""
    x, offset, mask, g, gc, k = pallas_case(case)
    want = np.asarray(_dcnv3_banded_dispatch(jnp.asarray(x), jnp.asarray(offset),
                                             jnp.asarray(mask), k, 1, 1, g, gc, 1.0,
                                             interpret=True))
    got = dcnv3_core(torch.from_numpy(x), torch.from_numpy(offset), torch.from_numpy(mask),
                     k, 1, 1, 1, g, gc, 1.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["in_band", "band_escape"])
def test_dcnv3_sampling_bfloat16_matches_pallas_kernel(case):
    """bfloat16 x, offset and mask: the wrapper's CPU path (the plain core,
    in float32 from the bfloat16 values, rounded to bfloat16) against JAX's
    Pallas kernel in interpret mode on the same bfloat16 inputs, which reads
    them as float32 and writes x's type (kernels/dcn_sampling.py:173, 262).
    The output's type is JAX's, and each value within one bfloat16 ulp of
    JAX's: the float32 sums are added in another order before rounding."""
    x, offset, mask, g, gc, k = pallas_case(case)
    port, ref = to_bfloat16(x, offset, mask)
    want = _dcnv3_banded_dispatch(*ref, k, 1, 1, g, gc, 1.0, interpret=True)
    got = dcnv3_sampling(*port, k, 1, 1, 1, g, gc, 1.0)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == want.shape
    assert bf16_ulp_gap(got, want) <= 1.0


def test_dcnv3_under_cpu_autocast_equals_float32_copies(monkeypatch):
    """Under CPU torch.autocast(bfloat16) DCNv3 hands the sampling its bfloat16
    projections and mask, which the plain version computes in float32: the
    output and every parameter's gradient equal, bit for bit, those of the same
    module whose sampling is handed float32 copies and its output rounded to
    bfloat16."""
    torch.manual_seed(0)
    m = PD.DCNv3(16, group=2)
    with torch.no_grad():
        m.offset.weight.normal_(0, 0.05)
        m.offset.bias.normal_(0, 1.0)
        m.mask.weight.normal_(0, 0.2)
    x = torch.randn(2, 7, 6, 16, generator=torch.Generator().manual_seed(1))
    real, seen = PD.dcnv3_sampling, []

    def run(sampling):
        monkeypatch.setattr(PD, "dcnv3_sampling", sampling)
        m.zero_grad()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            out = m(x)
        (out.float() * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        return [out.detach()] + [p.grad.clone() for p in m.parameters()]

    def direct(proj, offset, mask, *cfg):
        seen.append((proj.dtype, offset.dtype, mask.dtype))
        return real(proj, offset, mask, *cfg)

    def float_copies(proj, offset, mask, *cfg):
        return real(proj.float(), offset.float(), mask.float(), *cfg).to(proj.dtype)
    got, want = run(direct), run(float_copies)
    assert seen == [(torch.bfloat16,) * 3] and got[0].dtype == torch.bfloat16
    assert len(got) == len(want) == 1 + len(list(m.parameters()))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


MODULES = {  # name: (flax module, port module, NHWC input shape, input is NHWC for the port)
    "DCNv3": (lambda: JD.DCNv3(8), lambda: PD.DCNv3(8), (2, 7, 6, 8), True),
    "DCNv3_g2_k5": (lambda: JD.DCNv3(8, 5, 1, 2, group=2), lambda: PD.DCNv3(8, 5, 1, 2, group=2),
                    (1, 6, 6, 8), True),
    "DCNV3_YoLo": (lambda: JD.DCNV3_YoLo(8, 3), lambda: PD.DCNV3_YoLo(4, 8, 3), (1, 6, 7, 4), False),
    "Bottleneck_DCNV3": (lambda: JD.Bottleneck_DCNV3(8), lambda: PD.Bottleneck_DCNV3(8, 8),
                         (2, 6, 6, 8), False),
    "C3_DCNV3": (lambda: JD.C3_DCNV3(16, n=2), lambda: PD.C3_DCNV3(8, 16, n=2), (1, 8, 8, 8), False),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_dcn_module_matches_jax(name):
    """Seeded weights, offset and mask heads included (nonzero), carried by
    state_dict_from_flax with strict=True. The input's spread of 2 makes the
    offsets reach a few pixels."""
    make_jax, make_port, shape, port_nhwc = MODULES[name]
    jm = make_jax()
    v = random_variables(lambda k, x: jm.init(k, x, train=False), shape, seed=len(name))
    x = np.random.default_rng(1).normal(0, 2, shape).astype(np.float32)
    with highest():
        want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    pm = make_port().eval()
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        if port_nhwc:
            got = pm(torch.from_numpy(x)).numpy()
        else:
            got = nhwc(pm(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got, want, **TOL)


def test_compiler_matches_jax_on_dcnv3_config():
    d = dcn_cfg("yolov5s-seg.json")
    port, ref = parse_config(d), jax_parse_config(d)
    assert len(port.layers) == len(ref.layers)
    for p, r in zip(port.layers, ref.layers):
        assert (p.i, p.f, p.n, p.name, p.c2, p.kw()) == (r.i, r.f, r.n, r.name, r.c2, r.kw())
    assert (port.save, port.out_ch, port.anchors, port.nc) == (ref.save, ref.out_ch, ref.anchors, ref.nc)
    # the JAX compile quirk, copied: the row repeat stays a repeat of whole C3_DCNV3 modules
    assert [(port.layers[r].n, port.layers[r].c2) for r in DCN_ROWS] == [(2, 128), (3, 256), (1, 512)]
    assert port == parse_config(load_config(find_cfg("yolov5s-seg-dcnv3.json")))


def test_full_width_dcnv3_state_dict_matches_flax_tree():
    """yolov5s-seg-dcnv3 at full width: port state-dict keys and shapes equal
    the flax tree's, 7,212,351 parameters, strides (8, 16, 32)."""
    jm = JaxSegmentationModel(load_config(find_cfg("yolov5s-seg-dcnv3.json")))
    shapes = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(zeros)
    port = SegmentationModel("yolov5s-seg-dcnv3.json", device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert port.spec.strides == jm.spec.strides == (8, 16, 32)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax == 7_212_351
    dcn = [m for m in port.modules() if isinstance(m, PD.DCNv3)]
    assert [m.input_proj.in_features for m in dcn] == [64, 64, 128, 128, 128, 256]


def test_init_seeds_linears_and_zeroes_dcnv3_heads():
    """Linear weights come from the explicit generator (the global RNG plays no
    part) and the offset and mask heads start at zero, as in JAX."""
    d = dcn_cfg("yolov5n-seg.json")
    torch.manual_seed(123)
    a = SegmentationModel(d, device="cpu", generator=torch.Generator().manual_seed(5))
    torch.manual_seed(456)
    b = SegmentationModel(d, device="cpu", generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    dcn = [m for m in a.modules() if isinstance(m, PD.DCNv3)]
    assert len(dcn) == 6
    for m in dcn:
        for head in (m.offset, m.mask):
            assert not head.weight.any() and not head.bias.any()
        w = m.input_proj.weight
        assert not m.input_proj.bias.any()
        assert abs(w.std().item() * w.shape[1] ** 0.5 - 1) < 0.2  # N(0, 1/fan_in)


def test_cpu_path_needs_no_nvcc_or_gpu(monkeypatch):
    """On CPU tensors the wrapper never builds or loads the kernel, and the
    plain version it runs is differentiable and takes float64 as well; on the
    meta device it gives shapes."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a CUDA kernel")
    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(build, "_nvcc", refuse)
    x, offset, mask = (torch.from_numpy(a).requires_grad_()
                       for a in sampling_inputs(0, 1, 5, 6, 1, 4, 3))
    out = dcnv3_sampling(x, offset, mask, 3, 1, 1, 1, 1, 4, 1.0)
    out.square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (x, offset, mask))
    meta = dcnv3_sampling(*(t.detach().to("meta") for t in (x, offset, mask)),
                          3, 1, 1, 1, 1, 4, 1.0)
    assert meta.shape == (1, 5, 6, 4) and meta.device.type == "meta"
    double = [t.detach().double() for t in (x, offset, mask)]
    np.testing.assert_allclose(dcnv3_sampling(*double, 3, 1, 1, 1, 1, 4, 1.0).numpy(),
                               out.detach().numpy(), **TOL)
    with pytest.raises(TypeError, match="float64"):
        dcnv3_sampling(double[0], offset, mask, 3, 1, 1, 1, 1, 4, 1.0)
    with pytest.raises(ValueError, match="offset shape"):
        dcnv3_sampling(x, offset[..., :4], mask, 3, 1, 1, 1, 1, 4, 1.0)


@pytest.fixture(scope="module")
def nano_dcn():
    """yolov5n-seg with rows 4, 6 and 8 made C3_DCNV3, at 64 px on seeded
    weights: the JAX model, its variables, an input batch and the JAX outputs,
    unfused and fused (blocked=False)."""
    d = dcn_cfg("yolov5n-seg.json")
    jm = JaxSegmentationModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=0)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    fm, fv = jm.fuse(v, blocked=False)
    with highest():
        out = jm.apply(v, jnp.asarray(x), train=False)
        fout = fm.apply(fv, jnp.asarray(x), train=False)
    to_np = lambda o: (np.asarray(o[0]), np.asarray(o[1]), [np.asarray(r) for r in o[2]])  # noqa: E731
    return {"cfg": d, "jm": jm, "v": v, "x": x, "out": to_np(out), "fout": to_np(fout)}


def _port_model(nano_dcn):
    model = SegmentationModel(nano_dcn["cfg"], device="cpu")
    model.load_state_dict(state_dict_from_flax(nano_dcn["v"]), strict=True)
    return model.eval()


def _assert_outputs_close(model, nano_dcn, want):
    with torch.no_grad():
        pred, protos, raw = model(torch.from_numpy(nano_dcn["x"]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(pred.numpy(), want[0], **TOL)
    np.testing.assert_allclose(nhwc(protos), want[1], **TOL)
    assert len(raw) == len(want[2]) == 3
    for r, w in zip(raw, want[2]):
        assert r.shape == w.shape
        np.testing.assert_allclose(r.numpy(), w, **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_nano_dcnv3_model_matches_jax(nano_dcn, fused):
    model = _port_model(nano_dcn)
    if fused:
        model.fuse()
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    _assert_outputs_close(model, nano_dcn, nano_dcn["fout" if fused else "out"])


def test_nano_dcnv3_predict_images_matches_jax(nano_dcn, tmp_path):
    """The streaming predictor against the JAX predictor (Pallas letterbox in
    interpret mode) on the same image files, by the matching rule of
    tests/test_torch_port_predict.py."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    src = tmp_path / "frames"
    src.mkdir()
    for i, (h, w) in enumerate([(48, 64), (80, 60)]):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx / (3 + i) + rng.uniform(0, 6)) * np.cos(yy / (4 + i))
        im = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(src / f"im{i}.png"), im)
    kw = dict(imgsz=64, conf_thres=1e-6, nm=32, save_img=False)
    with highest():
        want = jax_predict_images(nano_dcn["jm"], nano_dcn["v"], str(src), device_preprocess=True,
                                  save_dir=str(tmp_path / "jax"), **kw)
    calls = dcnv3_sampling.launches
    got = predict_images(_port_model(nano_dcn), str(src), device="cpu",
                         save_dir=str(tmp_path / "port"), **kw)
    assert dcnv3_sampling.launches == calls  # a CPU run launches no kernel
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert g.shape[1] == w.shape[1] == 6 + 32
        assert len(w) > 50
        assert abs(len(g) - len(w)) <= 0.02 * len(w)
        assert match_detections(w, g) >= 0.98
