"""Shared helpers of the tests/test_torch_port_*.py files: seeded numpy
variables for a flax module, so the JAX package and the port run on the same
weights without a compiled JAX init, and seeded DCNv3 sampling inputs."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEG_CFG = ROOT / "yolo_dual_tpu" / "configs" / "segment"


def random_variables(init_fn, x_shape, seed):
    """Numpy variables shaped like `init_fn(key, x)` (traced with eval_shape,
    never compiled), filled from `np.random.default_rng(seed)`: conv kernels
    N(0, 1/fan_in), conv biases N(0, 0.5), BN scale U(0.5, 1.5), BN bias
    N(0, 0.2), running mean N(0, 0.2), running var U(0.5, 1.5). Non-trivial BN
    statistics make the conv+BN fold a real test."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x_shape, jnp.float32))

    def fill(tree, path=()):
        if hasattr(tree, "items"):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        shape, leaf = tuple(tree.shape), path[-1]
        in_bn = "bn" in path
        if leaf == "kernel":
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
