"""Shared helpers of the tests/test_torch_port_*.py files: seeded numpy
variables for a flax module, so the JAX package and the port run on the same
weights without a compiled JAX init, and seeded DCNv3 sampling inputs."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# Under pytest-xdist each worker takes its share of the cores for torch's
# intra-op threads: 6 workers at torch's default of a thread a core
# oversubscribe an 8-core box, and the port's tests ran ~2x slower in a
# whole run (a float64 gradcheck of tiny ops ~100x).
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))
SEG_CFG = ROOT / "yolo_dual_tpu" / "configs" / "segment"


def random_variables(init_fn, x_shape, seed):
    """Numpy variables shaped like `init_fn(key, x)` (traced with eval_shape,
    never compiled), filled from `np.random.default_rng(seed)`: conv kernels
    and the raw deformable weights (DCNv2's `weight`, C2f_DCN's
    `m_{i}_dcn_weight`) N(0, 1/fan_in), conv biases N(0, 0.5), BN scale
    U(0.5, 1.5), BN bias N(0, 0.2), running mean N(0, 0.2), running var
    U(0.5, 1.5). Non-trivial BN statistics make the conv+BN fold a real test."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x_shape, jnp.float32))

    def fill(tree, path=()):
        if hasattr(tree, "items"):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        shape, leaf = tuple(tree.shape), path[-1]
        in_bn = "bn" in path
        if leaf in ("kernel", "weight") or leaf.endswith("_dcn_weight"):
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf == "scale" or leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias" and not in_bn:
            v = rng.normal(0, 0.5, shape)
        else:  # BN bias, running mean
            v = rng.normal(0, 0.2, shape)
        return v.astype(np.float32)

    return fill(shapes)


def jax_train_float64(jm, v, x, jit=False):
    """JAX's train-mode apply of `jm` in float64: variables and input cast, and
    flax's BatchNorm statistics and normalisation, which the JAX package pins
    to float32, computed in float64 too; jitted with `jit` (one compile
    instead of one a primitive, for deep modules). Returns the output (an
    array, or a list of them as the module returns it) and the
    updated `batch_stats` tree (empty where the module has no BatchNorm)."""
    from flax.linen import normalization

    stats, norm = normalization._compute_stats, normalization._normalize

    def stats64(x, axes, dtype, *a, **k):
        return stats(x, axes, jnp.float64, *a, **k)

    def norm64(mdl, x, mean, var, reduction_axes, feature_axes, dtype, *a, **k):
        return norm(mdl, x, mean, var, reduction_axes, feature_axes, jnp.float64, *a, **k)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(normalization, "_compute_stats", stats64)
        mp.setattr(normalization, "_normalize", norm64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        def apply(v, x):
            return jm.apply(v, x, train=True, mutable=["batch_stats"])
        x64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), x)  # or a list
        out, upd = (jax.jit(apply) if jit else apply)(v64, x64)
        assert all(a.dtype == jnp.float64 for a in jax.tree_util.tree_leaves(out))
        return (jax.tree_util.tree_map(np.asarray, out),
                jax.tree_util.tree_map(np.asarray, dict(upd).get("batch_stats", {})))


def nhwc(t):
    """Port NCHW tensor -> NHWC numpy for comparison with JAX outputs."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def sampling_inputs(seed, b, h, w, g, gc, k, stride=1, offset_std=2.0):
    """Seeded channels-last DCNv3 sampling inputs: x N(0, 1), offsets
    N(0, offset_std px), a mask softmaxed over the k·k points of each group."""
    rng = np.random.default_rng(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.standard_normal((b, h, w, g * gc)).astype(np.float32)
    offset = (rng.standard_normal((b, ho, wo, g * k * k * 2)) * offset_std).astype(np.float32)
    logits = rng.standard_normal((b, ho, wo, g, k * k))
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, offset, mask.reshape(b, ho, wo, g * k * k).astype(np.float32)


def to_bfloat16(*arrays):
    """Each float32 array rounded to bfloat16 (torch's round to nearest even),
    as the port's torch tensors and as JAX's arrays of the same values."""
    port = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in arrays]
    return port, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in port]


def bf16_ulp_gap(got, want) -> float:
    """The largest |got - want| in bfloat16 ulps of the larger magnitude of the
    two values (the ulp of v: 2^(floor(log2 |v|) - 7)); equal zeros are 0 apart."""
    a = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    b = np.asarray(want).astype(np.float32)
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return float((np.abs(a - b) / ulp).max())


CORE_CASES = {  # name: (b, h, w, g, gc, k, stride, pad, dilation, offset_scale, offset_std)
    "g1": (2, 8, 9, 1, 4, 3, 1, 1, 1, 1.0, 2.0),
    "g2": (2, 8, 9, 2, 4, 3, 1, 1, 1, 1.0, 2.0),
    "offset_scale2": (1, 7, 6, 2, 3, 3, 1, 1, 1, 2.0, 2.0),
    "stride2": (1, 10, 8, 1, 5, 3, 2, 1, 1, 1.0, 2.0),
    "dilation2_k5": (1, 9, 9, 2, 2, 5, 1, 4, 2, 1.0, 1.5),
    "far_outside": (1, 6, 7, 2, 3, 3, 1, 1, 1, 1.0, 8.0),
}


# The TINY_SEG net of tests/test_eval_dp.py: 64 px, nc 3, nm 4.
TINY_SEG = dict(
    nc=3, depth_multiple=1.0, width_multiple=1.0,
    anchors=[[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
    backbone=[
        [-1, 1, "Conv", [8, 6, 2, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "C3", [16]],
        [-1, 1, "Conv", [24, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
    ],
    head=[[[3, 4], 1, "Segment", ["nc", "anchors", 4, 8]]],
)
IMGSZ, TINY_NC, TINY_NM = 64, 3, 4


def primed_tiny(seed=11):
    """The JAX TINY_SEG model and its seeded variables, primed as the JAX
    dryrun primes them (__graft_entry__.py:183-193) so masks are solid and
    both metric halves are non-zero: +3 objectness, +1 class and +2
    coefficient biases on the detect convs, +2 on the proto cv3 BN bias."""
    from yolo_dual_tpu.models.model import SegmentationModel
    jm = SegmentationModel(TINY_SEG)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False),
                         (1, IMGSZ, IMGSZ, 3), seed=seed)
    hp = v["params"][f"model_{jm.spec.layers[-1].i}"]
    for li in range(len(TINY_SEG["anchors"])):
        b = hp["detect"][f"m_{li}"]["bias"].reshape(3, -1)
        b[:, 4] += 3.0
        b[:, 5:5 + TINY_NC] += 1.0
        b[:, 5 + TINY_NC:] += 2.0
    hp["proto"]["cv3"]["bn"]["bias"] += 2.0
    return jm, v


def port_model(v):
    """The port's TINY_SEG on the CPU with the JAX variables `v`."""
    from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    model = SegmentationModel(TINY_SEG, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    return model


# Frame shapes of the training sets: long sides of 64 (r = 1 at IMGSZ), 128
# (r = 0.5, an integer shrink), 120 (r < 1, non-integer) and 30 (r > 1).
TRAIN_SHAPES = ((48, 64), (96, 128), (90, 120), (40, 30))


def write_yolo_split(root, split, n, shapes, seed, nc=TINY_NC):
    """n seeded frames of `shapes` (cycled) under root/{jax,port}/images/split,
    PNG for the JAX package and `.npy` of the same RGB pixels for the port,
    with the same polygon labels under each labels/split: 1-4 hexagons a
    frame of `nc` classes, each over a bright box so the model can find it;
    frame 2 has no label file, frame 5 an empty one. Returns root."""
    import cv2
    rng = np.random.default_rng(seed)
    for side in ("jax", "port"):
        (root / side / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / side / "labels" / split).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(0 if i == 5 else rng.integers(1, 5)):
            c, r = rng.uniform(0.2, 0.8, 2), rng.uniform(0.08, 0.3)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            pts = np.clip(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1), 0, 1)
            (x0, y0), (x1, y1) = (pts.min(0) * [w, h]).astype(int), (pts.max(0) * [w, h]).astype(int)
            im[y0:y1, x0:x1] = rng.integers(180, 256, 3)
            lines.append(" ".join([str(rng.integers(0, nc))] + [f"{v:.6f}" for v in pts.reshape(-1)]))
        cv2.imwrite(str(root / "jax" / "images" / split / f"im{i}.png"), im[..., ::-1])
        np.save(root / "port" / "images" / split / f"im{i}.npy", im)
        if i != 2:
            for side in ("jax", "port"):
                (root / side / "labels" / split / f"im{i}.txt").write_text("\n".join(lines))
    return root


SEM_CFG = ROOT / "yolo_dual_tpu" / "configs" / "semantic"
SEM_NC = 12


def narrow_semantic(name, div):
    """The JAX semantic config `name` with the same rows and every width but
    the class count divided by `div` (at least 4; a SegmentHead's width at
    least 2). Rows without a width (Softmax, Concat, both spellings of
    Upsample) and GAM, whose width the compiler takes from its input, keep
    their args, and so does every repeat argument (args[1] of C3, C3_DCN,
    C2f, C2f_DCN, C3k2)."""
    import yaml
    d = yaml.safe_load((SEM_CFG / f"{name}.yaml").read_text())
    for row in d["backbone"] + d["head"]:
        args = row[3]
        if row[2] == "SegmentHead":
            args[1] = max(args[1] // div, 2)
        elif row[2] not in ("nn.Softmax", "Concat", "Upsample", "nn.Upsample", "GAM") \
                and args[0] != d["nc"]:
            args[0] = max(args[0] // div, 4)
    return d


def flax_from_state_dict(v, sd):
    """The inverse of the port's `state_dict_from_flax`: JAX variables shaped
    as `v` holding the tensors of the port's state_dict `sd` (OIHW -> HWIO for
    conv kernels and the raw deformable weights, Linear -> Dense kernels).
    JAX's own torch import (`import_torch_state_dict`) reads neither DCNv2's
    `weight` nor C2f_DCN's `m_{i}_...` leaves."""
    from yolo_dual_tpu_torch.io.weights import _flatten, state_dict_from_flax
    keys = [k for k in state_dict_from_flax(v) if not k.endswith("num_batches_tracked")]
    leaves = [(coll, path, leaf) for coll in ("params", "batch_stats")
              for path, leaf in _flatten(v.get(coll, {}))]
    assert len(keys) == len(leaves)
    out = {}
    for key, (coll, path, leaf) in zip(keys, leaves):
        t = sd[key].detach().cpu().numpy()
        name = path[-1]
        if coll == "params" and (name in ("kernel", "weight") or name.endswith("_dcn_weight")):
            t = t.transpose(2, 3, 1, 0) if t.ndim == 4 else (t.T if t.ndim == 2 else t)
        assert t.shape == np.shape(leaf), (key, t.shape, np.shape(leaf))
        node = out.setdefault(coll, {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[name] = np.ascontiguousarray(t, dtype=np.asarray(leaf).dtype)
    return out


def write_json_set(root, n, shape, seed, nc=SEM_NC):
    """n seeded frames of `shape` (h, w) under root/jax/images as PNG and
    root/port/images as `.npy` of the same RGB pixels, and one JSON dense mask
    a frame under root/json: a background class and 3-6 rectangles of other
    classes, class nc - 1 (the ignored one) in every frame, each rectangle
    painted in the frame in a colour of its class plus noise. Returns root."""
    import json

    import cv2
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (nc, 3))
    for d in ("jax/images", "port/images", "json"):
        (root / d).mkdir(parents=True, exist_ok=True)
    h, w = shape
    for i in range(n):
        mask = np.full((h, w), rng.integers(0, nc - 1), np.uint8)
        for k in range(rng.integers(3, 7)):
            y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
            y1, x1 = y0 + rng.integers(3, h // 2 + 4), x0 + rng.integers(3, w // 2 + 4)
            mask[y0:y1, x0:x1] = nc - 1 if k == 0 else rng.integers(0, nc)
        im = np.clip(colours[mask] + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / "jax" / "images" / f"f{i:02d}.png"), im[..., ::-1])
        np.save(root / "port" / "images" / f"f{i:02d}.npy", im)
        (root / "json" / f"f{i:02d}.json").write_text(json.dumps({
            "filename": f"f{i:02d}.png", "shape": [h, w], "dtype": "uint8",
            "class_names": [], "mask_data": mask.reshape(-1).tolist()}))
    return root


def calibrated_semantic(jm, v, cfg, images):
    """JAX variables `v` of the semantic model `jm` with every BatchNorm's
    running statistics replaced by those of `images` ((b, 3, h, w) float in
    [0, 1]), taken through the port's model of `cfg` in train mode and carried
    back (`flax_from_state_dict`). With identity or random statistics a
    random network's scores collapse onto one class; calibrated, the argmax
    map holds several."""
    import torch

    from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    model = SemanticSegModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    for bn in model.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.reset_running_stats()
            bn.momentum = None  # a cumulative average: one batch sets its own statistics
    with torch.no_grad():
        model.train()(images)
    return flax_from_state_dict(v, model.state_dict())


def spread_offsets(v, seed, gain):
    """`v` with every DCNv2 offset head (`conv_offset_mask`) drawn so its
    offsets span ±2-3 px: biases U(−2, 2), a fixed shift of each kernel
    point, and the kernel × `gain`, the part that follows the features. JAX
    initialises these heads to zero, where every sample is a grid point. In a
    whole calibrated network offsets that follow the features steeply make it
    chaotic: at gain 1 the narrow yolov5_seg's float32 forward stands ~0.8
    from its float64 one, in JAX as in the port; at gain 0.1, 3e-5."""
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        if not hasattr(t, "items"):
            if "conv_offset_mask" not in path:
                return t
            if path[-1] == "kernel":
                return t * gain
            return rng.uniform(-2, 2, t.shape).astype(t.dtype)
        return {k: walk(x, path + (k,)) for k, x in t.items()}
    return {**v, "params": walk(v["params"])}


def narrow_calibrated(name, div, seed, images):
    """The narrow semantic config `name` (narrow_semantic), JAX's model of it
    and seeded variables (random_variables) with the DCNv2 offset heads
    spread at gain 0.1 (spread_offsets) and BatchNorm calibrated on `images`
    ((b, h, w, 3) uint8)."""
    import torch

    from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
    d = narrow_semantic(name, div)
    jm = JaxSemanticSegModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False),
                         (1, *images.shape[1:3], 3), seed=seed)
    x = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2).float() / 255
    return d, jm, calibrated_semantic(jm, spread_offsets(v, seed + 1, gain=0.1), d, x)


# The orbax fixture that chip_smoke.py reads on the card, where no JAX is
# installed: a checkpoint written by JAX's save_checkpoint in the trainers'
# layout, the JAX package's MultiBackend output on a seeded frame, and the
# model's config.
ORBAX_FIXTURE = ROOT / "tests" / "data" / "torch_port_orbax"
FIXTURE_WIDTH = 0.0625  # yolov5n-seg's 0.25 cut to a quarter; see write_orbax_fixture


def orbax_fixture_cfg():
    """yolov5n-seg with backbone rows 4, 6 and 8 made C3_DCNV3 (the nano model
    of tests/test_torch_port_dcn.py) at width_multiple FIXTURE_WIDTH."""
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    d = load_config(find_cfg("yolov5n-seg.json"))
    for r in (4, 6, 8):
        d["backbone"][r][2] = "C3_DCNV3"
    d["width_multiple"] = FIXTURE_WIDTH
    return d


def _bf16_representable(t):
    """float32 leaves rounded down to 16 significant bits: the checkpoint's
    zstd chunks then shrink by ~1/3, and the values stay float32 ones."""
    def cut(a):
        a = np.asarray(a)
        return (a.view(np.uint32) & 0xFFFF0000).view(np.float32) if a.dtype == np.float32 else a
    return jax.tree_util.tree_map(cut, t)


def write_orbax_fixture(out=ORBAX_FIXTURE, forward=True):
    """Write the fixture under `out` with the JAX package: `ckpt/`, JAX's
    save_checkpoint of {variables, ema: {ema, updates}, opt_state (the SGD
    state of train/optim.py:smart_optimizer), epoch, best_fitness} for
    orbax_fixture_cfg() on seeded weights; `cfg.json`; `input.npy`, a seeded
    (1, 64, 64, 3) uint8 frame; and `pred.npy` / `protos.npy` (NHWC), the
    output of JAX's MultiBackend on that checkpoint (its EMA, conv+BN
    folded) for the frame / 255, matmuls at "highest" precision (skipped
    with forward=False).

    The width is cut from yolov5n-seg's 0.25 to FIXTURE_WIDTH, and the
    weights rounded to 16 significant bits, to keep the committed files
    small: the ~370 leaves a tree make _METADATA and the inline `.zarray`
    records of the store's B-tree versions most of its size."""
    import json
    import shutil

    from yolo_dual_tpu.io.multibackend import MultiBackend as JaxMultiBackend
    from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
    from yolo_dual_tpu.train import save_checkpoint
    from yolo_dual_tpu.train.optim import smart_optimizer
    out = Path(out)
    cfg = orbax_fixture_cfg()
    jm = JaxSegmentationModel(cfg)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=0)
    rng = np.random.default_rng(1)
    ema = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.02, a.shape)).astype(np.float32), v)
    tx = smart_optimizer(v["params"], "SGD", {"lr0": 0.01, "momentum": 0.937,
                                              "weight_decay": 5e-4}, epochs=3, steps_per_epoch=4)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    save_checkpoint(out / "ckpt", {
        "variables": _bf16_representable(v),
        "ema": {"ema": _bf16_representable(ema), "updates": np.int32(12)},
        "opt_state": tx.init(v["params"]), "epoch": 2, "best_fitness": 0.125})
    (out / "cfg.json").write_text(json.dumps(cfg))
    x = np.random.default_rng(2).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    np.save(out / "input.npy", x)
    if not forward:
        return out
    with jax.default_matmul_precision("highest"):
        pred, protos = JaxMultiBackend(out / "ckpt", cfg=cfg, nc=80, imgsz=64).forward(
            x.astype(np.float32) / 255)
    np.save(out / "pred.npy", np.asarray(pred))
    np.save(out / "protos.npy", np.asarray(protos))
    return out
