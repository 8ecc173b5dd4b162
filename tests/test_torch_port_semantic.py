"""The semantic serving and evaluation path of the port against the JAX
package: the config copies, the compiler and the weight carry-over at full
width, the forward of narrow ResNet50 / ResNet18 / VGG16 graphs (unfused and
fused), the aligning Concat and the resizes, `semantic_preprocess` (the
device route around K1), the JSON dataset on both routes, the losses, the
confusion matrix, the panels, and `semantic.val` / `semantic.predict` end to
end on the CPU against JAX's `evaluate_semantic` and root `semantic/predict.py`.

Tolerances: forwards rtol 1e-4 / atol 1e-5 (float32, other summation orders);
preprocessed images 1e-6, masks exact; dataset samples and batches exact;
losses 1e-6 relative; the confusion matrix exact. End to end the narrow
ResNet50 carries BatchNorm statistics calibrated on the frames (random ones
collapse its argmax onto one class), and then its float32 scores stand far
from a float64 forward's, in JAX as in the port: the random graph with
calibrated BatchNorm amplifies rounding ~1.15x a layer, from 6e-7 relative
after the stem to 1.2e-3 at the softmax (measured with the port's float32
and float64 forwards). JAX's float32 scores stand 1.18e-3 from float64, the
port's fused ones 6.6e-4-7.7e-4, and the two 4e-4-1.28e-3 apart on a batch
at one to eight torch threads. So the scores must agree within SCORE_GAP =
2e-3, and the argmax maps except at pixels whose two best scores lie within
NEAR_TIE = 2 * SCORE_GAP, the most a gap can move when every score moves by
less than SCORE_GAP; those are counted, and the metrics agree to what they
can move (mIoU and per-class IoU 1e-4 when none flips, the val loss 1e-5
relative).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import (SEM_CFG, SEM_NC, calibrated_semantic, narrow_semantic, nhwc,
                               random_variables, write_json_set)
from yolo_dual_tpu.data.json_dataset import JSONSegmentDataset as JaxJSONDataset
from yolo_dual_tpu.data.loader import Loader as JaxLoader
from yolo_dual_tpu.engine import evaluate_semantic as jax_evaluate_semantic
from yolo_dual_tpu.kernels.preprocess import semantic_preprocess as jax_semantic_preprocess
from yolo_dual_tpu.losses import semantic as jax_loss
from yolo_dual_tpu.metrics.seg import SegmentationConfusionMatrix as JaxCM
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.nn import backbones as jax_backbones
from yolo_dual_tpu.nn import common as jax_common
from yolo_dual_tpu.utils import plots as jax_plots
from yolo_dual_tpu_torch.data import json_dataset
from yolo_dual_tpu_torch.data.loader import Loader
from yolo_dual_tpu_torch.engine.validator import evaluate_semantic
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.kernels.preprocess import (_nearest_indices, mask_indices,
                                                    semantic_preprocess,
                                                    semantic_preprocess_reference)
from yolo_dual_tpu_torch.losses import semantic as port_loss
from yolo_dual_tpu_torch.metrics.seg import SegmentationConfusionMatrix
from yolo_dual_tpu_torch.models.compiler import parse_config
from yolo_dual_tpu_torch.models.model import GraphModel, SemanticSegModel
from yolo_dual_tpu_torch.nn import backbones, common
from yolo_dual_tpu_torch.semantic import predict as predict_cli
from yolo_dual_tpu_torch.semantic import val as val_cli
from yolo_dual_tpu_torch.utils import plots

cv2 = pytest.importorskip("cv2")

PORT_CFG = SEM_CFG.parents[1].parent / "yolo_dual_tpu_torch" / "configs" / "semantic"
CONFIGS = ("resnet18", "resnet34", "resnet50", "resnet18_unet", "resnet34_unet", "vgg16",
           "yolov5_seg", "yolov8_seg", "yolov9_seg")
NARROW = {"resnet50": 16, "resnet18": 8, "vgg16": 16,  # config: width divisor
          "yolov5_seg": 16, "yolov8_seg": 16, "yolov9_seg": 16}
IMGSZ = 64
SCORE_GAP = 2e-3  # port and JAX float32 scores of the calibrated narrow ResNet50
NEAR_TIE = 2 * SCORE_GAP  # two best scores closer than this may swap between them
N_PREDICT = 3  # frames through both predict CLIs


def jax_model_and_variables(cfg, seed):
    """JAX's SemanticSegModel of `cfg` and seeded variables with non-trivial
    BatchNorm statistics (torch_port_common.random_variables)."""
    jm = JaxSemanticSegModel(cfg)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False),
                         (1, IMGSZ, IMGSZ, 3), seed=seed)
    return jm, v


def port_from(cfg, v):
    model = SemanticSegModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    return model.eval()


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# configs, compiler, weights at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_json_config_equals_yaml(name):
    port = json.loads((PORT_CFG / f"{name}.json").read_text())
    assert port == yaml.safe_load((SEM_CFG / f"{name}.yaml").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_full_width_graph_matches_jax_tree(name):
    """The port's meta build of each semantic config has JAX's parameter count
    and, after state_dict_from_flax, JAX's name -> shape map (BatchNorm
    eps 1e-5 and momentum 0.1 on every BatchNorm)."""
    d = yaml.safe_load((SEM_CFG / f"{name}.yaml").read_text())
    jm = JaxSemanticSegModel(d)
    shapes = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(zeros).items()}
    with torch.device("meta"):
        model = GraphModel(parse_config(d))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)


def test_resnet50_full_width_loads_jax_weights_strict():
    """resnet50.json at full width (nc 12) loads a JAX resnet50.yaml tree with
    strict=True, and a detect model built after it keeps its own BN profile."""
    jm, v = jax_model_and_variables(yaml.safe_load((SEM_CFG / "resnet50.yaml").read_text()), 0)
    model = SemanticSegModel("resnet50.json", device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    assert model.nc == SEM_NC and sum(p.numel() for p in model.parameters()) > 20e6
    w = v["params"]["model_1"]["block2"]["conv3"]["conv"]["kernel"]
    np.testing.assert_array_equal(model.model[1].layer[2].conv3.conv.weight.detach().numpy(),
                                  w.transpose(3, 2, 0, 1))
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    det = SegmentationModel("yolov5n-seg.json", device="cpu")
    assert {m.eps for m in det.modules() if isinstance(m, torch.nn.BatchNorm2d)} == {1e-3}


# ---------------------------------------------------------------------------
# forward parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(NARROW))
def test_forward_matches_jax(name):
    d = narrow_semantic(name, NARROW[name])
    jm, v = jax_model_and_variables(d, seed=1)
    x = np.random.default_rng(2).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x)))
    model = port_from(d, v)
    with torch.no_grad():
        got = nhwc(model(to_nchw(x)))
        assert got.shape == want.shape == (2, IMGSZ, IMGSZ, SEM_NC)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        got_fused = nhwc(model.fuse()(to_nchw(x)))
    np.testing.assert_allclose(got_fused, want, rtol=1e-4, atol=1e-5)
    assert all(m.bn is None for m in model.modules() if isinstance(m, common.Conv))


@pytest.mark.parametrize("shape,size", [((40, 40), (20, 20)), ((41, 37), (20, 19)),
                                        ((20, 20), (40, 40)), ((17, 23), (40, 40))])
def test_resizes_and_aligning_concat_match_jax(shape, size):
    """resize_bilinear (antialiased like jax.image.resize when shrinking), the
    aligning Concat built on it, and SegmentHead's align_corners resize."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, *size, 3)).astype(np.float32)
    b = rng.standard_normal((2, *shape, 5)).astype(np.float32)
    want = np.asarray(jax_common.resize_bilinear(jnp.asarray(b), size))
    np.testing.assert_allclose(nhwc(common.resize_bilinear(to_nchw(b), size)), want,
                               rtol=1e-5, atol=1e-6)
    cat = jax_common.Concat(align=True)
    want = np.asarray(cat.apply({}, [jnp.asarray(a), jnp.asarray(b)]))
    got = nhwc(common.Concat(align=True)([to_nchw(a), to_nchw(b)]))
    assert got.shape == (2, *size, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jax_backbones.resize_bilinear_ac(jnp.asarray(b), size))
    np.testing.assert_allclose(nhwc(backbones.resize_bilinear_ac(to_nchw(b), size)), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("align_corners,antialias", [(False, True), (True, False)])
@pytest.mark.parametrize("shape,size", [((41, 37), (20, 19)), ((17, 23), (40, 40)),
                                        ((48, 48), (96, 96))])
def test_deterministic_resize_backward(shape, size, align_corners, antialias):
    """The resize taken under torch.use_deterministic_algorithms on the card
    (common._DeterministicResize), run here on the CPU: its forward is
    F.interpolate's, its matrix-product backward equals F.interpolate's
    backward, and float64 gradcheck holds."""
    import torch.nn.functional as F
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, *shape)).astype(np.float64))
    g = torch.from_numpy(rng.standard_normal((2, 3, *size)).astype(np.float64))
    grads = []
    for resize in (lambda t: F.interpolate(t, size=size, mode="bilinear",
                                           align_corners=align_corners, antialias=antialias),
                   lambda t: common._DeterministicResize.apply(t, size, align_corners,
                                                               antialias)):
        xr = x.float().requires_grad_(True)
        out = resize(xr)
        out.backward(g.float())
        grads.append((out.detach().numpy(), xr.grad.numpy()))
    np.testing.assert_array_equal(grads[1][0], grads[0][0])
    np.testing.assert_allclose(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-5)
    x64 = x[:1, :1].clone().requires_grad_(True)
    # one torch thread: the gradcheck is thousands of tiny ops, and beside other
    # busy test workers torch's default of a thread a core made it ~100x slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(
            lambda t: common._DeterministicResize.apply(t, size, align_corners, antialias), (x64,))
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# semantic_preprocess (the device route) and the resizes of the host route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,augment", [(2, 45, 67, False), (2, 45, 67, True),
                                           (3, 70, 37, True), (2, 20, 24, False),
                                           (1, 48, 64, True)])
def test_semantic_preprocess_matches_jax(b, h, w, augment):
    """Odd sizes, a portrait frame, an upscale, an exact 3:4 frame; with and
    without the per-sample flip, brightness and contrast. On a CPU tensor the
    wrapper is its plain version."""
    rng = np.random.default_rng(h * w)
    im = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    mk = rng.integers(0, SEM_NC, (b, h, w)).astype(np.int32)
    aug = dict(flip=np.arange(b) % 2 == 0, bright=rng.uniform(0.8, 1.2, b).astype(np.float32),
               contr=rng.uniform(0.8, 1.2, b).astype(np.float32)) if augment else {}
    ji, jmask = jax_semantic_preprocess(jnp.asarray(im), jnp.asarray(mk), out_size=IMGSZ,
                                        interpret=True,
                                        **{k: jnp.asarray(v) for k, v in aug.items()})
    pi, pmask = semantic_preprocess(torch.from_numpy(im), torch.from_numpy(mk), IMGSZ, **aug)
    ri, rmask = semantic_preprocess_reference(torch.from_numpy(im), torch.from_numpy(mk), IMGSZ,
                                              **aug)
    assert pi.shape == (b, 3, IMGSZ, IMGSZ) and pmask.dtype == torch.int32
    np.testing.assert_allclose(nhwc(pi), np.asarray(ji), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    assert torch.equal(pi, ri) and torch.equal(pmask, rmask)


def test_mask_indices_are_made_once_a_geometry():
    """The mask gathers' index tensors are JAX's `_nearest_indices` and are
    built once for a geometry and device: a second batch reuses them."""
    cpu = torch.device("cpu")
    ry, rx = mask_indices(45, 67, 29, 43, cpu)
    np.testing.assert_array_equal(ry.numpy(), _nearest_indices(45, 29))
    np.testing.assert_array_equal(rx.numpy(), _nearest_indices(67, 43))
    again = mask_indices(45, 67, 29, 43, cpu)
    assert again[0] is ry and again[1] is rx
    assert mask_indices(45, 67, 43, 29, cpu)[0] is not ry


def test_resize_nearest_matches_cv2_and_the_routes_differ_as_jax_does():
    """The host route's INTER_NEAREST copy equals cv2 on random shapes, up and
    down; the device route's half-pixel indices are JAX's, and at CamVid's
    960 -> 640 they pick another source column than cv2 in 320 of 640."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 200, 4))
        m = rng.integers(0, 255, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(json_dataset.resize_nearest_u8(m, nh, nw),
                                      cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST))
    from yolo_dual_tpu.kernels.preprocess import _nearest_indices as jax_nearest
    ramp = np.tile(np.arange(960, dtype=np.float32), (2, 1))
    cv2_cols = cv2.resize(ramp, (640, 2), interpolation=cv2.INTER_NEAREST)[0].astype(np.int64)
    np.testing.assert_array_equal(_nearest_indices(960, 640), jax_nearest(960, 640))
    assert (cv2_cols != _nearest_indices(960, 640)).sum() == 320


def test_resize_and_pad_matches_jax():
    from yolo_dual_tpu.data.json_dataset import resize_and_pad as jax_resize_and_pad
    rng = np.random.default_rng(5)
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(10, 200, 2))
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        m = rng.integers(0, SEM_NC, (h, w), dtype=np.uint8)
        got, want = json_dataset.resize_and_pad(im, m, IMGSZ), jax_resize_and_pad(im, m, IMGSZ)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


# ---------------------------------------------------------------------------
# the JSON dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def json_set(tmp_path_factory):
    """10 seeded 72x96 frames with their JSON masks (PNG copies for JAX): a
    1.5x shrink to 48x64 on the 64-px canvas, where the two routes' mask
    resizes pick other pixels."""
    return write_json_set(tmp_path_factory.mktemp("sem"), 10, (72, 96), seed=6)


@pytest.mark.parametrize("route", ["host", "device", "device_augment"])
def test_dataset_and_loader_match_jax(json_set, route):
    """Every sample, and every batch of a shuffled Loader epoch (the last
    one padded), equal JAX's; the device route's flip / bright / contr draws
    come in JAX's order."""
    device, augment = route != "host", route == "device_augment"
    kw = dict(img_size=IMGSZ, augment=augment, num_classes=SEM_NC, seed=3,
              device_preprocess=device)
    jds = JaxJSONDataset(json_set / "jax" / "images", json_set / "json", **kw)
    pds = json_dataset.JSONSegmentDataset(json_set / "port" / "images", json_set / "json", **kw)
    assert len(pds) == len(jds) == 10
    flips = set()
    for i in range(len(pds)):
        got, want = pds[i], jds[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        flips.add(bool(got.get("flip")))
    assert len(flips) == (2 if augment else 1)
    jl = JaxLoader(jds, batch_size=4, shuffle=True, seed=1, prefetch=0)
    pl = Loader(pds, batch_size=4, shuffle=True, seed=1, prefetch=0)
    jbs, pbs = list(jl), list(pl)
    assert len(pbs) == len(jbs) == len(pl) == 3
    for got, want in zip(pbs, jbs):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_json_mask_cache_and_verify(json_set, tmp_path):
    from yolo_dual_tpu.data.json_dataset import _load_json_mask as jax_load
    src = json_set / "json" / "f03.json"
    j = tmp_path / "f03.json"
    j.write_text(src.read_text())
    first = json_dataset._load_json_mask(j)
    assert (tmp_path / "f03.json.npy").exists()
    np.testing.assert_array_equal(first, jax_load(src, cache=False))
    np.testing.assert_array_equal(json_dataset._load_json_mask(j), first)
    ok, missing = json_dataset.verify_json_masks(json_set / "port" / "images", json_set / "json")
    assert ok and not missing
    (tmp_path / "x.npy").write_bytes(b"")
    assert json_dataset.verify_json_masks(tmp_path, tmp_path) == (False, ["x.npy"])


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", ["dice", "jaccard", "ce"])
@pytest.mark.parametrize("smoothing,weighted", [(0.0, False), (0.1, True)])
def test_loss_matches_jax(flavor, smoothing, weighted):
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((2, 20, 24, SEM_NC)).astype(np.float32) * 3
    target = rng.integers(0, SEM_NC, (2, 20, 24)).astype(np.int32)
    w = rng.uniform(0.2, 3.0, SEM_NC).astype(np.float32) if weighted else None
    jl = jax_loss.SemanticSegLoss(SEM_NC, smoothing, w, flavor)
    pl = port_loss.SemanticSegLoss(SEM_NC, smoothing, w, flavor)
    _, want = jl(jnp.asarray(pred), jnp.asarray(target))
    _, got = pl(to_nchw(pred), torch.from_numpy(target))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.item(), float(j), rtol=1e-6, atol=1e-7)
    # a target at another size is nearest-resized (half-pixel) to the scores'
    big = rng.integers(0, SEM_NC, (2, 40, 48)).astype(np.int32)
    np.testing.assert_allclose(pl(to_nchw(pred), torch.from_numpy(big))[0].item(),
                               float(jl(jnp.asarray(pred), jnp.asarray(big))[0]), rtol=1e-6)


def test_class_weights_match_jax(json_set, tmp_path):
    files = sorted((json_set / "json").glob("*.json"))
    np.testing.assert_allclose(port_loss.seg_labels_to_class_weights(files, SEM_NC),
                               jax_loss.seg_labels_to_class_weights(files, SEM_NC), rtol=1e-6)
    names = [f"c{i}" for i in range(SEM_NC)]
    weights = {n: float(i + 1) for i, n in enumerate(names)}
    (tmp_path / "w.json").write_text(json.dumps(weights))
    (tmp_path / "w.yaml").write_text(yaml.safe_dump(weights))
    csv = ",".join(str(float(i)) for i in range(SEM_NC))
    for spec in (str(tmp_path / "w.json"), str(tmp_path / "w.yaml"), csv):
        np.testing.assert_array_equal(port_loss.parse_class_weights(spec, SEM_NC, names),
                                      jax_loss.parse_class_weights(spec, SEM_NC, names))
    assert port_loss.parse_class_weights("", SEM_NC) is None
    with pytest.raises(ValueError, match="3 weights for 12 classes"):
        port_loss.parse_class_weights("1,2,3", SEM_NC)


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(8)
    port, ref = SegmentationConfusionMatrix(SEM_NC, 11), JaxCM(SEM_NC, 11)
    for _ in range(3):
        pred = rng.integers(-1, SEM_NC + 1, (2, 30, 40))
        target = rng.integers(0, SEM_NC - 2, (2, 30, 40))  # classes 10 and 11 absent: NaN IoU
        target[0, 0, :5] = [-1, SEM_NC, 3, 4, 255]
        port.update(pred, target)
        ref.update(pred, target)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    got, want = port.get_metrics(), ref.get_metrics()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    empty = SegmentationConfusionMatrix(SEM_NC, 11)
    assert empty.compute_iou()[0] == JaxCM(SEM_NC, 11).compute_iou()[0] == 0.0


def test_semantic_panel_matches_jax():
    rng = np.random.default_rng(9)
    im = rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    gt, pred = rng.integers(0, SEM_NC, (2, IMGSZ, IMGSZ))
    names = val_cli.CLASS_NAMES
    np.testing.assert_array_equal(plots.CAMVID_PALETTE, jax_plots.CAMVID_PALETTE)
    np.testing.assert_array_equal(plots.semantic_panel(im, gt, pred, names=names),
                                  jax_plots.semantic_panel(im, gt, pred, names=names))
    imf = im.astype(np.float32) / 255
    np.testing.assert_array_equal(plots.semantic_panel(imf, gt, pred),
                                  jax_plots.semantic_panel(imf, gt, pred))


# ---------------------------------------------------------------------------
# the slice: semantic.val and semantic.predict against JAX on the CPU
# ---------------------------------------------------------------------------


def narrow_calibrated_cli(name, json_set, tmp_path_factory, jax_orbax=False):
    """JAX's narrow `name` and its variables, BatchNorm calibrated on the
    set's first 8 frames (host route), the same weights as a `.pt`
    state_dict for the port's CLIs, and the weights JAX's CLIs read: the
    `.pt` too, or with `jax_orbax` an orbax checkpoint of the variables (JAX's
    own `.pt` import fills C2f_DCN's `m_{i}_...` leaves from none of them)."""
    d = narrow_semantic(name, NARROW[name])
    jm, v = jax_model_and_variables(d, seed=12)
    ds = json_dataset.JSONSegmentDataset(json_set / "port" / "images", json_set / "json",
                                         img_size=IMGSZ)
    v = calibrated_semantic(jm, v, d, to_nchw(np.stack([ds[i]["image"] for i in range(8)]))
                            .float() / 255)
    root = tmp_path_factory.mktemp("sem_cli")
    cfg = root / f"{name}_narrow.json"
    cfg.write_text(json.dumps(d))
    weights = root / f"{name}_narrow.pt"
    torch.save(state_dict_from_flax(v), weights)
    jax_weights = weights
    if jax_orbax:
        from yolo_dual_tpu.train.checkpoint import save_checkpoint
        jax_weights = root / f"{name}_narrow_orbax"
        save_checkpoint(jax_weights, {"variables": v})
    scores = jax.jit(lambda x: jm.apply(v, x))  # JAX's scores of (b, s, s, 3) images
    return jm, scores, v, cfg, weights, jax_weights


@pytest.fixture(scope="module")
def narrow_resnet50(json_set, tmp_path_factory):
    return narrow_calibrated_cli("resnet50", json_set, tmp_path_factory)


@pytest.fixture(scope="module")
def narrow_yolov8(json_set, tmp_path_factory):
    """The narrow yolov8_seg (C2f, C2f_DCN; its backbone ends in an Upsample
    row), calibrated as narrow_resnet50."""
    return narrow_calibrated_cli("yolov8_seg", json_set, tmp_path_factory, jax_orbax=True)


def near_tie_pixels(scores):
    """Pixels whose two best scores (last axis) lie within NEAR_TIE."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < NEAR_TIE


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host", "device"])
def test_val_cli_matches_jax_evaluate_semantic(json_set, narrow_resnet50, device_preprocess):
    """semantic.val.run on the CPU against JAX's evaluate_semantic on JAX's
    loader, same weights: the argmax maps of every batch agree except at near
    ties (counted), so the confusion matrices do; mIoU, per-class IoU and the
    val loss agree; the maps hold several classes."""
    jm, jax_scores, v, cfg, weights, _ = narrow_resnet50
    kw = dict(img_size=IMGSZ, num_classes=SEM_NC, device_preprocess=device_preprocess)
    jloader = JaxLoader(JaxJSONDataset(json_set / "jax" / "images", json_set / "json", **kw),
                        batch_size=4, prefetch=0)
    want, want_iou, _ = jax_evaluate_semantic(jm, v, jloader, SEM_NC, ignore_index=11,
                                              loss_fn=jax_loss.SemanticSegLoss(SEM_NC))
    got, got_iou, (ms,) = val_cli.run(
        weights=str(weights), cfg=str(cfg), img_dir=str(json_set / "port" / "images"),
        json_dir=str(json_set / "json"), imgsz=IMGSZ, batch_size=4, device="cpu",
        device_preprocess=device_preprocess)
    assert ms > 0

    # the confusion matrices, pixel by pixel: JAX's scores on JAX's batches
    # against the port's fused model on the port's
    model = port_from(json.loads(cfg.read_text()), v).fuse()
    ploader = Loader(json_dataset.JSONSegmentDataset(json_set / "port" / "images",
                                                     json_set / "json", **kw), batch_size=4)
    jcm, pcm = JaxCM(SEM_NC, 11), SegmentationConfusionMatrix(SEM_NC, 11)
    ties = flips = 0
    classes = set()
    for jb, pb in zip(jloader, ploader):
        n = int(pb["n_valid"])
        if device_preprocess:
            jim, jmk = jax_semantic_preprocess(jnp.asarray(jb["image_raw"]),
                                               jnp.asarray(jb["mask_raw"]), out_size=IMGSZ,
                                               interpret=True)
            pim, pmk = semantic_preprocess(torch.from_numpy(pb["image_raw"]),
                                           torch.from_numpy(pb["mask_raw"]), IMGSZ)
        else:
            jim, jmk = jnp.asarray(jb["image"]).astype(jnp.float32) / 255, jb["mask"]
            pim, pmk = to_nchw(pb["image"]).float() / 255, torch.from_numpy(pb["mask"])
        scores = np.asarray(jax_scores(jim))[:n]
        with torch.no_grad():
            pscores = nhwc(model(pim))[:n]
        np.testing.assert_allclose(pscores, scores, rtol=0, atol=SCORE_GAP)
        pred, jpred = pscores.argmax(-1), scores.argmax(-1)
        tie = near_tie_pixels(scores)
        ties += int(tie.sum())
        flips += int((pred != jpred).sum())
        assert not (pred != jpred)[~tie].any()
        classes |= set(np.unique(jpred).tolist())
        jcm.update(jpred, np.asarray(jmk)[:n])
        pcm.update(pred, pmk.numpy()[:n])
    assert flips <= ties
    assert np.abs(pcm.matrix - jcm.matrix).sum() <= 2 * flips
    assert len(classes) >= 4, classes

    # a flipped pixel moves a class's IoU by at most 1 / its union
    union = jcm.matrix.sum(0) + jcm.matrix.sum(1) - np.diag(jcm.matrix)
    tol = 1e-4 + flips / max(union[union > 0].min() - flips, 1)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got_iou, want_iou, rtol=0, atol=tol)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    print(f"{'device' if device_preprocess else 'host'} route: {flips} argmax flips, "
          f"{ties} near-tie pixels, classes {sorted(classes)}, mIoU {got[0]} / {want[0]}")


def test_predict_cli_writes_jax_masks(json_set, narrow_resnet50, tmp_path, monkeypatch):
    """semantic.predict.run writes the masks, overlays and panels of root
    semantic/predict.py (PNG, through cv2) from the same `.pt` weights, equal
    except at near-tie pixels (counted on JAX's scores of the letterboxed
    frames), and its mIoU / pixel accuracy against the JSON masks. JAX's CLI
    starts from a zero tree in place of its eager random init (~30 s on the
    CPU), which the `.pt` import then fills."""
    predict_cli_matches_jax(json_set, narrow_resnet50, tmp_path, monkeypatch)


def test_predict_cli_writes_jax_masks_yolov8_seg(json_set, narrow_yolov8, tmp_path, monkeypatch):
    """As test_predict_cli_writes_jax_masks, with the narrow yolov8_seg."""
    predict_cli_matches_jax(json_set, narrow_yolov8, tmp_path, monkeypatch)


def predict_cli_matches_jax(json_set, narrow, tmp_path, monkeypatch):
    import importlib.util
    import shutil
    _, jax_scores, v, cfg, weights, jax_weights = narrow
    monkeypatch.setattr(JaxSemanticSegModel, "init", lambda self, *a, **k: jax.tree_util.tree_map(
        np.zeros_like, v))
    for side, ext in (("jax", "png"), ("port", "npy")):
        (tmp_path / side).mkdir()
        for i in range(N_PREDICT):
            shutil.copy(json_set / side / "images" / f"f{i:02d}.{ext}", tmp_path / side)
    spec = importlib.util.spec_from_file_location(
        "jax_semantic_predict", SEM_CFG.parents[2] / "semantic" / "predict.py")
    jax_predict = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_predict)
    want, jdir = jax_predict.run(weights=str(jax_weights), cfg=str(cfg),
                                 source=str(tmp_path / "jax"), imgsz=IMGSZ,
                                 gt_json_dir=str(json_set / "json"), project=str(tmp_path),
                                 name="jax_out")
    got, pdir, speed = predict_cli.run(weights=str(weights), cfg=str(cfg),
                                       source=str(tmp_path / "port"), imgsz=IMGSZ,
                                       gt_json_dir=str(json_set / "json"), project=str(tmp_path),
                                       name="port_out", device="cpu")
    assert len(speed) == 3 and min(speed) > 0
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir()) and len(names) == 3 * N_PREDICT
    padded = np.stack([json_dataset.resize_and_pad(np.load(tmp_path / "port" / f"f{i:02d}.npy"),
                                                   None, IMGSZ)[0] for i in range(N_PREDICT)])
    near = near_tie_pixels(np.asarray(jax_scores(jnp.asarray(padded, jnp.float32) / 255)))
    flips = ties = 0
    for i, tie in enumerate(near):
        ties += int(tie.sum())
        for kind in ("mask", "overlay", "panel"):
            a, b = (cv2.imread(str(d / f"f{i:02d}_{kind}.png")) for d in (pdir, jdir))
            differ = (a != b).any(-1)
            if kind == "panel":  # [input | GT | pred | diff | legend]: pred and diff may flip
                differ = differ[:, :4 * IMGSZ].reshape(IMGSZ, 4, IMGSZ)
                assert not differ[:, :2].any()
                differ = differ[:, 2] | differ[:, 3]
            assert not (differ & ~tie).any(), (i, kind)
            flips += int(differ.sum()) if kind == "mask" else 0
    assert flips <= ties
    np.testing.assert_allclose(got["mIoU"], want["mIoU"], rtol=0, atol=1e-4 + 1e-2 * flips)
    np.testing.assert_allclose(got["Accuracy"], want["Accuracy"], rtol=0,
                               atol=flips / (N_PREDICT * IMGSZ * IMGSZ) + 1e-12)


def test_val_cli_visualize_and_refusals(json_set, tmp_path):
    d = narrow_semantic("resnet18", NARROW["resnet18"])
    cfg = tmp_path / "resnet18_narrow.json"
    cfg.write_text(json.dumps(d))
    kw = dict(cfg=str(cfg), img_dir=str(json_set / "port" / "images"),
              json_dir=str(json_set / "json"), imgsz=IMGSZ, batch_size=4, device="cpu")
    val_cli.run(visualize=True, device_preprocess=True, project=str(tmp_path), name="vis", **kw)
    panels = sorted((tmp_path / "vis").glob("panel_*.png"))
    assert len(panels) == 4 and cv2.imread(str(panels[0])).shape == (IMGSZ, 4 * IMGSZ + 160, 3)
    with pytest.raises(NotImplementedError, match="A10"):
        val_cli.run(data_parallel=True, **kw)
    with pytest.raises(NotImplementedError, match="A10"):
        evaluate_semantic(SemanticSegModel(d, device="cpu"), [], SEM_NC, mesh=object(),
                          device="cpu")
    # the host route's augmentation and the converters are ported (the training
    # slice; tests/test_torch_port_semantic_train.py holds them against JAX)
    aug = json_dataset.JSONSegmentDataset(json_set / "port" / "images", json_set / "json",
                                          img_size=IMGSZ, augment=True)
    assert aug[0]["image"].shape == (IMGSZ, IMGSZ, 3)
    (tmp_path / "no_masks").mkdir()
    assert json_dataset.batch_convert_masks_to_json(tmp_path / "no_masks", tmp_path / "json") == 0
    with pytest.raises(ValueError, match="semantic config"):
        SemanticSegModel("yolov5n-seg.json", device="cpu")
    assert val_cli.parse_opt(["--img-dir", "a", "--json-dir", "b"]).device == "cuda"
    assert predict_cli.parse_opt(["--source", "a"]).device == "cuda"
