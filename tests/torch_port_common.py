"""Shared helpers of the tests/test_torch_port_*.py files: seeded numpy
variables for a flax module, so the JAX package and the port run on the same
weights without a compiled JAX init, and seeded DCNv3 sampling inputs."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
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
