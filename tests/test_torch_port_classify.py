"""The classification slice of the port against the JAX package on the CPU:
the Classify head, ClassificationModel and build_classifier's models, their
initial weights, the classify data (transforms, dataset, loader), the loss
and the optimizer groups.

Tolerances: Classify within 1e-5 (eval mode; train mode against JAX's apply
in float64, as tests/test_torch_port_detect.py holds modules); whole
classifiers' logits within 1e-4 of their largest magnitude on seeded weights;
`flax_init_` within 8 float32 ulps of JAX's `init` (as
tests/test_torch_port_semantic_yolo.py holds it), zeros and ones exact; the
data bit for bit; `classify_loss` within 1e-6; the optimizer groups name for
name.
"""

import importlib.util
import random
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import ROOT, jax_train_float64, random_variables
from yolo_dual_tpu.data import classify as JD
from yolo_dual_tpu.nn import common as JC
from yolo_dual_tpu.train.optim import param_group_label as jax_group_label
from yolo_dual_tpu.train.trainer import classify_loss as jax_classify_loss
from yolo_dual_tpu_torch.classify.train import TORCHVISION_ARCHS, build_classifier
from yolo_dual_tpu_torch.data import classify as PD
from yolo_dual_tpu_torch.io.weights import _flatten, state_dict_from_flax
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.models.model import (ClassificationModel, build_model,
                                              reshape_classifier_output)
from yolo_dual_tpu_torch.nn import common as PC
from yolo_dual_tpu_torch.train.optim import smart_optimizer
from yolo_dual_tpu_torch.train.trainer import classify_loss

cv2 = pytest.importorskip("cv2")

# build_classifier(name, 1000) at 224 px: parameters, BatchNorm statistics (JAX's eval_shape)
SIZES = {"yolov5s.yaml": (6110376, 13120), "resnet18": (13115432, 12160),
         "resnet34": (23223592, 19584), "resnet50": (27413032, 55680),
         "wide_resnet50_2": (70739240, 70784), "MobileNetV3s": (2947848, 14672),
         "mobilenet_v2": (5145832, 36672), "efficientnet_b0": (6929508, 44576),
         "efficientnet_b1": (9435144, 64608), "efficientnet_v2_s": (23099448, 156432),
         "RegNety400": (5749904, 29712), "vgg11_bn": (11162152, 8064),
         "convnext_tiny": (30085192, 2560)}


def jax_classify_train():
    """JAX's root classify/train.py as a module (it shares its file name with
    segment/train.py, so it is loaded under a name of its own)."""
    if "jax_classify_train" not in sys.modules:
        spec = importlib.util.spec_from_file_location("jax_classify_train",
                                                      ROOT / "classify" / "train.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["jax_classify_train"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["jax_classify_train"]


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the head and the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("inputs", [1, 2], ids=["tensor", "list"])
def test_classify_head_matches_jax(inputs, train):
    rng = np.random.default_rng(inputs)
    xs = [rng.standard_normal((2, 5, 6, c)).astype(np.float32) for c in (8, 4)[:inputs]]
    jm = JC.Classify(7, k=3, s=2)
    x_jax = [jnp.asarray(x) for x in xs] if inputs > 1 else jnp.asarray(xs[0])
    v = random_variables(lambda k, _: jm.init(k, x_jax, train=False), xs[0].shape, seed=5)
    port = PC.Classify(12 if inputs > 1 else 8, 7, k=3, s=2)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    port.train(train)
    x_port = [to_nchw(x) for x in xs] if inputs > 1 else to_nchw(xs[0])
    with torch.no_grad():
        got = port(x_port).numpy()
    if train:
        want, upd = jax_train_float64(jm, v, xs if inputs > 1 else xs[0])
        sd = port.state_dict()
        for k, w in state_dict_from_flax({"batch_stats": upd}).items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    else:
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jm.apply(v, x_jax, train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["yolov5n.yaml", "resnet18"])
def test_classifier_logits_match_jax(name):
    """build_classifier's model on JAX's seeded weights: logits within 1e-4
    of their largest magnitude at 64 px, batch 2; the port's model is the
    ClassificationModel that build_model(task="classify") gives."""
    jm = jax_classify_train().build_classifier(name, 10)
    x = np.random.default_rng(2).uniform(-2, 2, (2, 64, 64, 3)).astype(np.float32)
    v = random_variables(lambda k, xx: jm.module.init(k, xx, train=False), x.shape, seed=9)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: jm.module.apply(v, x, train=False))(v, x))
    port = build_classifier(name, 10, device="cpu")
    if name == "yolov5n.yaml":
        other = build_model("yolov5n.json", task="classify", nc=10, device="cpu")
        assert type(other) is ClassificationModel and other.state_dict().keys() == \
            port.state_dict().keys()
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = port.eval()(to_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    assert rel_err(got, want) <= 1e-4
    assert port.stride == [32] and port.names[9] == "9" and port.spec.style == "classify"


@pytest.mark.parametrize("name", list(SIZES))
def test_classifier_trees_match_jax(name):
    """The name -> shape map of JAX's tree (jax.eval_shape of init at 224
    px, nc 1000, no FLOPs), a strict load of it, and the parameter and
    BatchNorm-statistic counts of the issue's table."""
    assert set(SIZES) == {"yolov5s.yaml", *TORCHVISION_ARCHS}
    assert TORCHVISION_ARCHS == jax_classify_train().TORCHVISION_ARCHS
    jm = jax_classify_train().build_classifier(name, 1000)
    shapes = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 224, 224, 3),
                                                                        jnp.float32))
    sd = state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    port = build_classifier(name, 1000, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} \
        == {k: tuple(v.shape) for k, v in sd.items()}
    port.load_state_dict(sd, strict=True)
    n_params = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_stats = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert sum(p.numel() for p in port.parameters()) == n_params
    assert (n_params, n_stats) == SIZES[name]
    assert port.save == frozenset(s for s in jm.spec.save if s < len(jm.spec.layers))


def test_reshape_classifier_output_keeps_all_but_the_linear():
    model = build_classifier("resnet18", 5, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    new = reshape_classifier_output(model, 3)
    assert new.nc == 3 and new.model[-1].linear.weight.shape == (3, 1280)
    old, sd = model.state_dict(), new.state_dict()
    assert old.keys() == sd.keys()
    for k, v in sd.items():
        if k.startswith("model.3.linear."):
            assert v.shape[0] == 3
        else:
            assert torch.equal(v, old[k]), k
    assert reshape_classifier_output(new, 3) is new


@pytest.mark.parametrize("name", ["yolov5n.yaml", "convnext_tiny"])
def test_flax_init_equals_jax_init_under_seed(name):
    """flax_init_(model, seed=3) against JAX's `module.init(PRNGKey(3))`, the
    init of JAX's classify/train.py under --seed 3: Dense kernels, LayerNorm
    scales and biases, ConvNeXt's gamma and the conv kernels."""
    jm = jax_classify_train().build_classifier(name, 10)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    want = state_dict_from_flax(jax.jit(lambda k: jm.module.init(k, x, train=True))(
        jax.random.PRNGKey(3)))
    got = flax_init_(build_classifier(name, 10, device="cpu"), seed=3).state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == torch.float32 and not (w == w.flatten()[0]).all():
            np.testing.assert_array_max_ulp(got[k].numpy(), w.numpy(), maxulp=8)
        else:
            assert torch.equal(got[k], w), k


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

SHAPES = ((48, 64), (40, 30), (60, 60), (33, 47), (32, 32))


def write_class_set(root, n, seed):
    """n seeded frames a class of SHAPES (cycled) for 3 classes under
    root/jax (PNG) and root/port (`.npy` of the same RGB pixels)."""
    rng = np.random.default_rng(seed)
    for c in ("cat", "dog", "eel"):
        for side in ("jax", "port"):
            (root / side / c).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            im = rng.integers(0, 256, SHAPES[i % len(SHAPES)] + (3,), dtype=np.uint8)
            cv2.imwrite(str(root / "jax" / c / f"{i}.png"), im[..., ::-1])
            np.save(root / "port" / c / f"{i}.npy", im)
    return root


def test_transforms_equal_jax():
    rng = np.random.default_rng(0)
    for shape in SHAPES + ((224, 300), (17, 250)):
        im = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        for size in (32, 45, 224):
            assert np.array_equal(PD.center_crop_resize(im, size), JD.center_crop_resize(im, size))
            assert np.array_equal(PD.classify_transforms(im, size),
                                  JD.classify_transforms(im, size))
        for seed in range(4):
            a, b = random.Random(seed), random.Random(seed)
            assert np.array_equal(PD.random_resized_crop(im, 32, rng=a),
                                  JD.random_resized_crop(im, 32, rng=b))
            assert np.array_equal(PD.color_jitter(im, 0.4, a), JD.color_jitter(im, 0.4, b))
            assert a.getstate() == b.getstate()
    x = rng.uniform(-2, 2, (4, 4, 3)).astype(np.float32)
    assert np.array_equal(PD.denormalize_imagenet(x), JD.denormalize_imagenet(x))


@pytest.mark.parametrize("source, cache", [("npy", False), ("npy", "ram"), ("png", "disk"),
                                           ("png", "ram")])
def test_dataset_and_loader_equal_jax(tmp_path, source, cache):
    """Two shuffled, augmented epochs and the eval samples, through the
    Loaders, bit for bit against JAX's dataset on the PNGs under the same
    cache: from the `.npy` frames, or from PNG copies (with the disk cache,
    whose BGR `.npy` files make no samples of their own)."""
    root = write_class_set(tmp_path, 5, seed=1)
    port_dir = root / "port"
    if source == "png":
        shutil.copytree(root / "jax", root / "port_png")
        port_dir = root / "port_png"
    for augment in (True, False):
        jl, jds = JD.create_classification_dataloader(root / "jax", imgsz=32, batch_size=4,
                                                      augment=augment, cache=cache, seed=3)
        pl, pds = PD.create_classification_dataloader(port_dir, imgsz=32, batch_size=4,
                                                      augment=augment, cache=cache, seed=3)
        assert pds.classes == jds.classes and len(pds) == len(jds) == 15
        assert len(pl) == len(jl)
        for epoch in range(2 if augment else 1):
            jl.set_epoch(epoch), pl.set_epoch(epoch)
            for jb, pb in zip(jl, pl):
                assert jb.keys() == pb.keys()
                for k in jb:
                    assert np.array_equal(jb[k], pb[k]) and jb[k].dtype == pb[k].dtype, k
    if cache == "disk":  # the cache files are JAX's and the set reads the same with them
        assert len(list(port_dir.rglob("*.npy"))) == 15
        for f in port_dir.rglob("*.npy"):
            assert np.array_equal(np.load(f), np.load(root / "jax" / f.relative_to(port_dir)))
        again = PD.ClassificationDataset(port_dir, imgsz=32)
        assert len(again) == 15 and all(s[2] is not None for s in again.samples)


def test_npy_frame_is_rgb_and_a_cache_is_not_a_sample(tmp_path):
    root = write_class_set(tmp_path, 2, seed=2)
    frame = np.load(root / "port" / "cat" / "0.npy")
    mixed = root / "mixed" / "cat"
    mixed.mkdir(parents=True)
    shutil.copy(root / "jax" / "cat" / "0.png", mixed / "0.png")
    np.save(mixed / "0.npy", frame[..., ::-1])  # its BGR disk cache
    np.save(mixed / "1.npy", frame)  # a frame of its own
    ds = PD.ClassificationDataset(root / "mixed", imgsz=32)
    assert [s[0].name for s in ds.samples] == ["0.png", "1.npy"]
    assert np.array_equal(ds._read(0), frame) and np.array_equal(ds._read(1), frame)
    ds.cache_disk = True
    assert np.array_equal(ds._read(0), frame)


# ---------------------------------------------------------------------------
# the loss and the optimizer groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classify_loss_matches_jax(smoothing):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((16, 7)) * 3).astype(np.float32)
    labels = rng.integers(0, 7, 16).astype(np.int32)
    want, (_, wacc) = jax_classify_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got, (_, acc) = classify_loss(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    assert abs(got.item() - float(want)) <= 1e-6 and acc.item() == float(wacc)


@pytest.mark.parametrize("name", ["convnext_tiny", "yolov5s.yaml"])
def test_optimizer_groups_match_jax(name):
    """The port's three groups against JAX's param_group_label, name for name:
    LayerNorm scales in g1 (no decay), ConvNeXt's gamma in g0."""
    jm = jax_classify_train().build_classifier(name, 10)
    shapes = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 32, 32, 3),
                                                                        jnp.float32))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    names = list(state_dict_from_flax({"params": params}))
    want = {n: jax_group_label(path) for n, (path, _) in zip(names, _flatten(params))}
    opt = smart_optimizer(build_classifier(name, 10, device="cpu"), "Adam", {"lr0": 1e-3})
    got = {n: g for g, ns in opt.names.items() for n in ns}
    assert got == want
    if name == "convnext_tiny":
        assert got["model.0.s0_b0.ln.weight"] == "g1" and got["model.0.s0_b0.gamma"] == "g0"
