"""The semantic training slice's parts against the JAX package and OpenCV:
the numpy copies of cv2.warpAffine and cv2.GaussianBlur, the augmented host
samples and the device route's draws through the Loader, the PNG -> JSON
converters, the native mask scanner, the synthetic CamVid scene, the
optimizer's parameter groups, the semantic losses' gradients, and the
semantic train step (one step, and an accumulate-2 cycle with the EMA)
against JAX's `Trainer.make_train_step`.

Tolerances, measured values in brackets:
- warpAffine (INTER_LINEAR with border 128 on frames, INTER_NEAREST with
  border 0 on masks) and GaussianBlur (5x5, sigma 0) against OpenCV 5 on 40
  random shapes of 2-260 px and angles in ±10°, and at 720x960: exact
  [0 of 6.6 M values differ];
- the augmented samples, the device-route draws and every batch of two
  shuffled epochs, the converters' JSON bytes, the scanner's masks and the
  synthetic arrays: exact;
- the loss gradients: 1e-5 relative to the gradient's largest magnitude
  [1.8e-7];
- the train step (narrow calibrated ResNet50, 64 px, bs 2, float32, JAX at
  "highest" matmul precision): loss items 1e-4 relative [3.2e-7]; every
  gradient and parameter update normwise within 3e-2 of the tensor's
  largest (+ 1e-6) after one step [1.7e-2], 7e-2 after an accumulate-2
  cycle [6.4e-2]. The deep, narrow graph's backward is ill-conditioned in
  float32: against a float64 run of the port, JAX's float32 gradients stand
  up to 2.1e-2 of a tensor's largest away and its cycle's updates up to
  6.5e-2, the port's own up to 1.3e-2 and 1.5e-2 (the BatchNorm parameters
  of the ResNet stages; JAX's BatchNorm takes its variance as E[x²] − E[x]²
  in float32), so the cycle also holds the port's float32 update within
  2e-2 of its float64 one. BatchNorm statistics, and after one step the new
  parameters and EMA values, elementwise rtol 1e-3 / atol 1e-4.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import (SEM_NC, calibrated_semantic, narrow_semantic, random_variables,
                               write_json_set)
from yolo_dual_tpu.data import json_dataset as jax_json_dataset
from yolo_dual_tpu.data import tools as jax_tools
from yolo_dual_tpu.data.loader import Loader as JaxLoader
from yolo_dual_tpu.losses import semantic as jax_loss
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.native import parse_mask_json_bytes as jax_parse_mask_json_bytes
from yolo_dual_tpu.train import ModelEMA as JModelEMA
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu.train.optim import param_group_label as j_param_group_label
from yolo_dual_tpu_torch import native
from yolo_dual_tpu_torch.data import json_dataset, tools
from yolo_dual_tpu_torch.data.augment import (gaussian_blur5_u8, get_rotation_matrix_2d,
                                              warp_affine_u8)
from yolo_dual_tpu_torch.data.loader import Loader
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.losses import semantic as port_loss
from yolo_dual_tpu_torch.models.model import SemanticSegModel
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import param_group_label, smart_optimizer
from yolo_dual_tpu_torch.train.trainer import Trainer
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

HYP = load_config(find_cfg("hyp.scratch-seg.yaml"))
IMGSZ = 64
NARROW = {"resnet50": 16, "resnet18": 8, "resnet18_unet": 8, "vgg16": 16,
          "yolov5_seg": 16, "yolov8_seg": 16, "yolov9_seg": 16}
STEP_RTOL, CYCLE_RTOL, FLOAT64_RTOL = 3e-2, 7e-2, 2e-2
ELEMENT_TOL = dict(rtol=1e-3, atol=1e-4)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def assert_normwise_close(got, want, rtol, atol=1e-6, what=""):
    """max |got − want| ≤ rtol · max |want| + atol, for one tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, (what, err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the numpy copies of OpenCV's warpAffine and GaussianBlur
# ---------------------------------------------------------------------------


def random_cases(seed, n=40):
    rng = np.random.default_rng(seed)
    shapes = [(720, 960)] + [(int(rng.integers(2, 260)), int(rng.integers(2, 260)))
                             for _ in range(n)]
    for h, w in shapes:
        yield rng, h, w, float(rng.uniform(-10, 10))


def test_rotation_matrix_equals_cv2():
    for _, h, w, a in random_cases(1):
        want = cv2.getRotationMatrix2D((w / 2, h / 2), a, 1.0)
        np.testing.assert_array_equal(get_rotation_matrix_2d(a, (w / 2, h / 2), 1.0), want)


@pytest.mark.parametrize("kind", ["linear_frame", "nearest_mask"])
def test_warp_affine_equals_cv2(kind):
    """Every value, at the shapes where the row has a scalar tail and where
    it has none (960 = 60 · 16), pixels past the border included."""
    for rng, h, w, a in random_cases(2 if kind == "linear_frame" else 3):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), a, 1.0)
        if kind == "linear_frame":
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                                  borderValue=(128, 128, 128))
            got = warp_affine_u8(img, m, (w, h), linear=True, border=128)
        else:
            img = rng.integers(0, SEM_NC, (h, w), dtype=np.uint8)
            want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST, borderValue=0)
            got = warp_affine_u8(img, m, (w, h), linear=False, border=0)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} at {a:.3f} degrees")


def test_gaussian_blur_equals_cv2():
    for rng, h, w, _ in random_cases(4):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(gaussian_blur5_u8(img), cv2.GaussianBlur(img, (5, 5), 0),
                                      err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(gaussian_blur5_u8(img[..., 0]),
                                      cv2.GaussianBlur(img[..., 0], (5, 5), 0))


# ---------------------------------------------------------------------------
# the dataset's two training routes, through the Loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def json_set(tmp_path_factory):
    """10 seeded 72x96 frames (PNG for JAX, `.npy` for the port) and masks."""
    return write_json_set(tmp_path_factory.mktemp("sem_train"), 10, (72, 96), seed=16)


EVERY_BRANCH = dict(hflip=0.5, vflip=0.5, rot_p=0.8, blur_p=0.6, crop_p=0.7, crop_scale=0.6)


@pytest.mark.parametrize("aug", ["defaults", "every_branch"])
def test_augmented_host_samples_match_jax(json_set, aug, monkeypatch):
    """The host route with augment=True (JAX's aug_params defaults, or every
    branch often): every batch of two shuffled epochs through the Loader,
    drop_last as the training loader has it, equals JAX's, and the draws
    reach each branch of `_augment_pair`."""
    params = EVERY_BRANCH if aug == "every_branch" else None
    kw = dict(img_size=IMGSZ, augment=True, num_classes=SEM_NC, seed=5, aug_params=params)
    jds = jax_json_dataset.JSONSegmentDataset(json_set / "jax" / "images", json_set / "json", **kw)
    pds = json_dataset.JSONSegmentDataset(json_set / "port" / "images", json_set / "json", **kw)
    assert pds.p == jds.p
    calls = {"warp_affine_u8": 0, "gaussian_blur5_u8": 0}
    for name in calls:
        def counted(*a, _fn=getattr(json_dataset, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(json_dataset, name, counted)
    jl = JaxLoader(jds, batch_size=4, shuffle=True, seed=2, drop_last=True, prefetch=0)
    pl = Loader(pds, batch_size=4, shuffle=True, seed=2, drop_last=True, prefetch=0)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jbs, pbs = list(jl), list(pl)
        assert len(pbs) == len(jbs) == len(pl) == 2
        for got, want in zip(pbs, jbs):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].dtype == want[k].dtype, k
    assert pds.rng.getstate() == jds.rng.getstate()
    if aug == "every_branch":  # a frame and its mask per rotation
        assert calls["warp_affine_u8"] >= 8 and calls["gaussian_blur5_u8"] >= 2, calls


def test_device_route_draws_and_batches_match_jax(json_set):
    """The device route's flip / bright / contr draws and raw batches over two
    shuffled epochs, and the CLI's two loaders (training: augment, shuffle,
    drop_last; val: in order, the last batch padded) against JAX's."""
    kw = dict(img_size=IMGSZ, batch_size=4, augment=True, num_classes=SEM_NC, seed=9,
              device_preprocess=True)
    jl, _ = jax_json_dataset.create_json_segment_dataloader(
        json_set / "jax" / "images", json_set / "json", **kw)
    pl, _ = json_dataset.create_json_segment_dataloader(
        json_set / "port" / "images", json_set / "json", **kw)
    jl.prefetch = pl.prefetch = 0
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jbs, pbs = list(jl), list(pl)
        assert len(pbs) == len(jbs) == 2
        for got, want in zip(pbs, jbs):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].dtype == want[k].dtype, k
    flips = np.concatenate([b["flip"] for b in pbs])
    assert flips.any() and not flips.all()
    jv, _ = jax_json_dataset.create_json_segment_dataloader(
        json_set / "jax" / "images", json_set / "json", IMGSZ, 4, drop_last=False)
    pv, _ = json_dataset.create_json_segment_dataloader(
        json_set / "port" / "images", json_set / "json", IMGSZ, 4, drop_last=False)
    jbs, pbs = list(jv), list(pv)
    assert len(pbs) == len(jbs) == len(pv) == 3 and int(pbs[-1]["n_valid"]) == 2
    for got, want in zip(pbs, jbs):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# PNG -> JSON, the native scanner, the synthetic scene
# ---------------------------------------------------------------------------


def test_mask_converters_write_jax_bytes(tmp_path):
    """mask_to_json and batch_convert_masks_to_json write what JAX's write,
    byte for byte, from PNG masks; a `.npy` mask gives the same record but
    for its file name."""
    rng = np.random.default_rng(3)
    png = tmp_path / "png"
    png.mkdir()
    for i in range(4):
        m = rng.integers(0, SEM_NC, (17 + i, 23), dtype=np.uint8)
        cv2.imwrite(str(png / f"m{i}.png"), m)
        np.save(tmp_path / f"m{i}.npy", m)
    (png / "notes.txt").write_text("not a mask")
    names = tools.CAMVID_NAMES
    jax_json_dataset.mask_to_json(png / "m1.png", tmp_path / "jax.json", names)
    json_dataset.mask_to_json(png / "m1.png", tmp_path / "port.json", names)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    json_dataset.mask_to_json(tmp_path / "m1.npy", tmp_path / "npy.json", names)
    want, got = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "npy.json"))
    assert got.pop("filename") == "m1.npy" and want.pop("filename") == "m1.png"
    assert got == want
    assert jax_json_dataset.batch_convert_masks_to_json(png, tmp_path / "j") == \
        json_dataset.batch_convert_masks_to_json(png, tmp_path / "p") == 4
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "p" / f.name).read_bytes() == f.read_bytes(), f.name


def test_native_scanner_matches_json_and_jax(tmp_path, monkeypatch):
    """The port's fastmask, built under build/native, parses records as
    `json` and JAX's scanner do: JAX's spacing, compact separators, values
    clamped or not; with the scanner absent, the `json` fallback."""
    assert native.load() is not None, "the native scanner did not build (g++ is on the path)"
    assert native.SO.parent == native.BUILD_DIR and native.BUILD_DIR.name == "native"
    rng = np.random.default_rng(4)
    for i, (shape, seps) in enumerate((((13, 7), None), ((64, 48), (",", ":")),
                                       ((1, 300), (", ", ": ")))):
        m = rng.integers(0, 256, shape, dtype=np.uint8)
        raw = json.dumps({"filename": "x.png", "shape": list(shape), "dtype": "uint8",
                          "class_names": ["a"], "mask_data": m.reshape(-1).tolist()},
                         separators=seps).encode()
        got = native.parse_mask_json_bytes(raw)
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(got, jax_parse_mask_json_bytes(raw))
        monkeypatch.setitem(native._STATE, "module", None)
        np.testing.assert_array_equal(native.parse_mask_json_bytes(raw), m)
        monkeypatch.undo()


def test_synthetic_camvid_scene_equals_jax(tmp_path):
    for n, size, seed in ((24, 96, 11), (5, 64, 3)):
        for got, want in zip(tools.synthetic_camvid_arrays(n, size, seed),
                             jax_tools.synthetic_camvid_arrays(n, size, seed)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    img_dir, json_dir = tools.write_synthetic_camvid_scene(tmp_path / "port", 6, 64)
    jimg, jjson = jax_tools.write_synthetic_camvid_scene(tmp_path / "jax", 6, 64)
    imgs, _ = jax_tools.synthetic_camvid_arrays(6, 64)
    for i in range(6):
        np.testing.assert_array_equal(np.load(img_dir / f"{i:03d}.npy"), imgs[i])
        assert (json_dir / f"{i:03d}.json").read_bytes() == (jjson / f"{i:03d}.json").read_bytes()


# ---------------------------------------------------------------------------
# optimizer groups, loss gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(NARROW))
def test_parameter_groups_match_jax(name):
    """The optimizer's g0 / g1 / g2, tensor by tensor, against JAX's labels of
    the same variables carried through the weight rule."""
    d = narrow_semantic(name, NARROW[name])
    jm = JaxSemanticSegModel(d)
    v = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    labels = jax.tree_util.tree_map_with_path(lambda p, _: j_param_group_label(p), v["params"])
    want = {k: str(lab) for k, lab in
            zip(state_dict_from_flax({"params": jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape), v["params"])}), jax.tree_util.tree_leaves(labels))}
    model = SemanticSegModel(d, device="cpu")
    opt = smart_optimizer(model, "SGD", HYP)
    got = {n: g for g, names in opt.names.items() for n in names}
    assert got == want
    assert {"g0", "g1", "g2"} == set(got.values())


def test_a_batchnorm_not_named_bn_is_in_g1():
    """A bare BatchNorm row (`model.1.weight`) is a BatchNorm scale, as JAX
    labels its `scale`; by name alone it would be taken for a weight."""
    model = torch.nn.Module()
    model.model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    opt = smart_optimizer(model, "SGD", HYP)
    assert opt.names == {"g0": ["model.0.weight"], "g1": ["model.1.weight"],
                         "g2": ["model.0.bias", "model.1.bias"]}
    assert param_group_label("model.1.weight") == "g0"


@pytest.mark.parametrize("flavor", ["dice", "jaccard", "ce"])
@pytest.mark.parametrize("smoothing,weighted", [(0.0, False), (0.1, False), (0.0, True),
                                                (0.1, True)])
def test_loss_gradient_matches_jax(flavor, smoothing, weighted):
    """The gradient of the total loss with respect to the scores, on scores
    from a softmax (what the semantic graphs emit) and on raw ones."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 20, 24, SEM_NC)).astype(np.float32) * 3
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    target = rng.integers(0, SEM_NC, (2, 20, 24)).astype(np.int32)
    w = rng.uniform(0.2, 3.0, SEM_NC).astype(np.float32) if weighted else None
    jl = jax_loss.SemanticSegLoss(SEM_NC, smoothing, w, flavor)
    pl = port_loss.SemanticSegLoss(SEM_NC, smoothing, w, flavor)
    for pred in (scores, logits):
        want = np.asarray(jax.grad(lambda p: jl(p, jnp.asarray(target))[0])(jnp.asarray(pred)))
        x = to_nchw(pred).clone().requires_grad_(True)
        pl(x, torch.from_numpy(target))[0].backward()
        got = x.grad.permute(0, 2, 3, 1).numpy()
        assert_normwise_close(got, want, 1e-5, atol=0.0, what=flavor)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

BS, EPOCHS, STEPS = 2, 3, 4


def semantic_batch(seed):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, SEM_NC, (BS, IMGSZ, IMGSZ)).astype(np.int32)
    colours = rng.integers(0, 256, (SEM_NC, 3))
    image = np.clip(colours[mask] + rng.integers(-30, 31, (BS, IMGSZ, IMGSZ, 3)), 0, 255)
    return {"image": image.astype(np.uint8), "mask": mask}


@pytest.fixture(scope="module")
def semantic_steps():
    """JAX's semantic train step from the calibrated narrow ResNet50: one step
    at accumulate 1 (in warmup and past it), and two micro-steps of an
    accumulate-2 cycle with the EMA."""
    d = narrow_semantic("resnet50", NARROW["resnet50"])
    jm = JaxSemanticSegModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=3)
    batches = [semantic_batch(s) for s in (1, 2)]
    v = calibrated_semantic(jm, v, d, to_nchw(batches[0]["image"]).float() / 255)
    loss = jax_loss.SemanticSegLoss(SEM_NC)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    out = {"cfg": d, "v": v, "batches": batches}
    with jax.default_matmul_precision("highest"):
        for accumulate in (1, 2):
            tx = j_smart_optimizer(v["params"], "SGD", HYP, epochs=EPOCHS, steps_per_epoch=STEPS,
                                   accumulate=accumulate, total_batch_size=BS)
            tr = JTrainer(jm, loss, tx, ema=JModelEMA(), task="semantic", accumulate=accumulate)
            step = jax.jit(tr.make_train_step())
            s = tr.init_state(v)
            if accumulate == 1:
                grad_fn = jax.jit(jax.grad(tr._forward_loss, has_aux=True))
                jb = {k: jnp.asarray(a) for k, a in batches[0].items()}
                for count in (0, 100):
                    sc = s.replace(opt_state=s.opt_state._replace(
                        count=jnp.asarray(count, jnp.int32)))
                    s1, metrics = step(sc, jb)
                    out[count] = {"state": to_np({"params": s1.params,
                                                  "batch_stats": s1.batch_stats}),
                                  "ema": to_np(s1.ema), "items": np.asarray(metrics["items"]),
                                  "grads": to_np(grad_fn(sc.params, sc.batch_stats, jb)[0])}
            else:
                for b in batches:
                    s, metrics = step(s, {k: jnp.asarray(a) for k, a in b.items()})
                out["cycle"] = {"state": to_np({"params": s.params,
                                                "batch_stats": s.batch_stats}),
                                "ema": to_np(s.ema), "items": np.asarray(metrics["items"])}
    return out


def port_trainer(steps, accumulate=1, count=0, dtype=torch.float32):
    model = SemanticSegModel(steps["cfg"], device="cpu")
    model.load_state_dict(state_dict_from_flax(steps["v"]), strict=True)
    model.to(dtype)
    opt = smart_optimizer(model, "SGD", HYP, epochs=EPOCHS, steps_per_epoch=STEPS,
                          accumulate=accumulate, total_batch_size=BS)
    opt.count = count
    tr = Trainer(model, port_loss.SemanticSegLoss(SEM_NC), opt, ModelEMA(model), task="semantic")
    return tr, tr.init_state()


def assert_state_matches(state, want, start, rtol, elementwise=True):
    """New parameters and EMA values (their change normwise, and with
    `elementwise` the values too), BatchNorm statistics elementwise, against
    JAX's tree `want`; each BatchNorm counts the micro-steps."""
    params = dict(state.model.named_parameters())
    for got, tree, what in ((state.model.state_dict(), want["state"], "model"),
                            (state.ema.ema.state_dict(), want["ema"]["ema"], "ema")):
        for k, w in state_dict_from_flax(tree).items():
            if k.endswith("num_batches_tracked"):
                assert got[k].item() == state.step, k
                continue
            if k in params:
                assert_normwise_close(got[k] - start[k], w - start[k], rtol, what=f"{what} {k}")
            if k not in params or elementwise:
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), **ELEMENT_TOL,
                                           err_msg=f"{what} {k}")
    assert state.ema.updates == int(want["ema"]["updates"])


@pytest.mark.parametrize("count", [0, 100], ids=["warmup", "past_warmup"])
def test_semantic_train_step_matches_jax(semantic_steps, count):
    """One train_step of the semantic task: loss items, gradients, updates,
    BatchNorm statistics (momentum 0.1, biased variance) and the EMA."""
    want = semantic_steps[count]
    tr, state = port_trainer(semantic_steps, count=count)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = tr.train_step(state, semantic_steps["batches"][0])
    np.testing.assert_allclose(metrics["items"].numpy(), want["items"], rtol=1e-4, atol=1e-7)
    assert metrics["loss"].item() == pytest.approx(float(want["items"][0]), rel=1e-4)
    params = dict(state.model.named_parameters())
    wg = state_dict_from_flax({"params": want["grads"]})
    assert wg.keys() == params.keys()
    for k, g in wg.items():
        assert_normwise_close(params[k].grad, g, STEP_RTOL, what=f"grad {k}")
    assert_state_matches(state, want, start, STEP_RTOL)
    moved = {k for k in params if not torch.equal(state.model.state_dict()[k], start[k])}
    groups = {n: g for g, names in state.optimizer.names.items() for n in names}
    assert {groups[k] for k in moved} == ({"g2"} if count == 0 else {"g0", "g1", "g2"})


def test_semantic_accumulation_cycle_matches_jax(semantic_steps):
    """Two micro-steps at accumulate 2: the first changes no parameter and no
    EMA, the second applies the mean gradient and advances the EMA once; the
    port's float32 update also against its own float64 one."""
    updates = {}
    for dtype in (torch.float64, torch.float32):
        tr, state = port_trainer(semantic_steps, accumulate=2, dtype=dtype)
        start = {k: v.clone() for k, v in state.model.state_dict().items()}
        names = [n for n, _ in state.model.named_parameters()]
        for i, b in enumerate(semantic_steps["batches"]):
            if dtype == torch.float64:
                b = {"image": to_nchw(b["image"]).double() / 255, "mask": b["mask"]}
            state, metrics = tr.train_step(state, b)
            if i == 0:
                assert all(torch.equal(state.model.state_dict()[k], start[k]) for k in names)
                assert state.ema.updates == 0
        assert state.optimizer.count == 1 and state.ema.updates == 1
        updates[dtype] = {k: state.model.state_dict()[k] - start[k] for k in names}
    np.testing.assert_allclose(metrics["items"].numpy(), semantic_steps["cycle"]["items"],
                               rtol=1e-4, atol=1e-7)
    assert_state_matches(state, semantic_steps["cycle"], start, CYCLE_RTOL, elementwise=False)
    for k in names:
        assert_normwise_close(updates[torch.float32][k], updates[torch.float64][k], FLOAT64_RTOL,
                              what=f"float32 update {k}")


def test_semantic_batch_forms_give_one_loss(semantic_steps):
    """The host route's uint8 NHWC batch and the device route's float NCHW
    one in [0, 1] (semantic_preprocess's output) are the same input: neither
    is scaled or permuted twice."""
    tr, state = port_trainer(semantic_steps)
    b = semantic_steps["batches"][0]
    with torch.no_grad():
        a = tr.forward_loss(state.model.eval(), b)
        x = to_nchw(b["image"]).float() / 255
        c = tr.forward_loss(state.model, {"image": x, "mask": b["mask"]})
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_trainer_refuses_an_unknown_task():
    with pytest.raises(ValueError, match="semantic"):
        Trainer(None, None, None, task="pose")


def test_hyp_json_equals_the_yaml():
    jax_hyp = find_cfg("hyp.scratch-seg.yaml").parents[3] / "yolo_dual_tpu" / "configs" / "hyps"
    assert load_config(find_cfg("hyp.scratch-seg.yaml")) == \
        yaml.safe_load((jax_hyp / "hyp.scratch-seg.yaml").read_text())
