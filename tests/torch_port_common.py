"""Shared helpers of the tests/test_torch_port_*.py files: seeded numpy
variables for a flax module, so the JAX package and the port run on the same
weights without a compiled JAX init."""

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
