"""The initial weights of the JAX package's `model.init()`, drawn again in torch.

JAX's semantic trainer (root semantic/train.py) starts every run from
`SemanticSegModel.init()`: flax's initializers under `jax.random.PRNGKey(0)`;
its classify trainer (root classify/train.py:74) under `PRNGKey(seed)`.
`flax_init_` gives a port model those same values, so a run from scratch
starts where JAX's does. It copies what the values depend on:

- the threefry-2x32 generator with JAX's partitionable random bits (bits of
  element i: the two output words of threefry(key, (0, i)), xor-ed);
- flax's key of a parameter: `fold_in(PRNGKey(0), h)` with h the first four
  bytes (big-endian) of the SHA-1 of the parameter's scope path and its
  counter in that scope (flax.core.scope: LazyRng, `_fold_in_static`,
  `make_rng`; the 1-based order in which the scope creates its parameters);
- the initializers: conv kernels lecun_normal (a normal truncated to ±2,
  std sqrt(1/fan_in) / 0.8796..., drawn on the HWIO shape), Dense kernels
  the same on the (in, out) shape, C2f_DCN's `m_{i}_dcn_weight` the same,
  DCNv2's `weight` uniform in ±1/sqrt(cin·k²), DCNv2's `conv_offset_mask`,
  every bias and BatchNorm or LayerNorm shift zero, their scales one,
  ConvNeXt's layer scale `gamma` 1e-6, running statistics 0 and 1, transposed
  conv kernels lecun_normal on JAX's (k, k, c2, c1) shape, Sum's gates
  -arange(1, n) / 2;
- the Detect bias prior of JAX's `init(bias_prior=True)` on a model with a
  Detect, Segment or DetectAux head (models/model.py:initialize_detect_biases).

The inverse error function is XLA's single-precision one (Giles'
polynomials), evaluated here in float32 by torch: values agree with JAX's to
a few float32 ulps (tests/test_torch_port_semantic_yolo.py).
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn as nn

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32 constants of jax.random.truncated_normal(key, -2, 2): erf(∓2/√2) and √2
_ERF_LO, _ERF_HI = -0.9544997215270996, 0.9544997215270996
_SQRT2 = 1.4142135381698608
_TRUNC_STD = 0.8796256610342398  # std of a unit normal truncated to ±2


def _threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds (jax._src.prng._threefry2x32_lowering), on
    int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _fold_in(key, data: int):
    """jax.random.fold_in(key, uint32(data)): threefry(key, (0, data))."""
    y0, y1 = _threefry2x32(key[0], key[1], torch.zeros(1, dtype=torch.int64),
                           torch.tensor([data], dtype=torch.int64))
    return int(y0), int(y1)


def param_key(path, counter: int, root=(0, 0)):
    """flax's key of the `counter`-th parameter made in the scope `path` under
    the root key `root` (PRNGKey(0) = (0, 0))."""
    m = hashlib.sha1()
    for x in (*path, counter):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return _fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def _uniform01_bits(key, n: int, device) -> torch.Tensor:
    """n float32 in [0, 1) from JAX's partitionable 32-bit random bits."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000  # a float in [1, 2) with 23 random mantissa bits
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once, as XLA's fused multiply-add: the float32
    product is exact in float64."""
    return (a.double() * b + c).float()


def uniform(key, shape, lo: float, hi: float, device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, lo, hi): f·(hi − lo) + lo, one
    rounding, as XLA fuses it."""
    lo32 = torch.tensor(lo, dtype=torch.float32, device=device)
    hi32 = torch.tensor(hi, dtype=torch.float32, device=device)
    f = _uniform01_bits(key, math.prod(shape), device)
    return torch.maximum(lo32, _fma32(f, (hi32 - lo32).double(), lo32.double())).reshape(shape)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function (Giles, "Approximating the erfinv
    function"), as jax.lax.erf_inv computes it in single precision."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    ws = w - 2.5
    wl = torch.sqrt(w) - 3.0
    f32 = lambda c: float(torch.tensor(c, dtype=torch.float32))  # noqa: E731
    ps = torch.full_like(x, 2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941):
        ps = _fma32(ps, ws.double(), f32(c))
    pl = torch.full_like(x, -0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682):
        pl = _fma32(pl, wl.double(), f32(c))
    out = torch.where(small, ps, pl) * x
    return torch.where(x.abs() == 1.0, x * torch.inf, out)


def lecun_normal(key, shape, device="cpu") -> torch.Tensor:
    """flax.linen.initializers.lecun_normal()(key, shape, float32) for a
    kernel of `shape` (HWIO, or (in, out)): fan_in = the product of all but
    the last dimension."""
    fan_in = math.prod(shape[:-1])
    std = torch.sqrt(torch.tensor(1.0 / fan_in, dtype=torch.float32)) \
        / torch.tensor(_TRUNC_STD, dtype=torch.float32)
    u = uniform(key, shape, _ERF_LO, _ERF_HI, device)
    out = torch.tensor(_SQRT2, dtype=torch.float32) * _erfinv32(u)
    lim = torch.nextafter(torch.tensor(2.0), torch.tensor(0.0)).item()
    return out.clamp(-lim, lim) * std.to(device)


def jax_scope(name: str):
    """The JAX scope path and leaf of a port parameter name (the inverse of
    io/weights.py:state_dict_from_flax's names): `model.{i}[.{r}]` ->
    `model_{i}[_{r}]`, `m.{j}` -> `m_{j}`, `layer.{j}` -> `block{j}`."""
    segs = name.split(".")
    leaf, segs = segs[-1], segs[:-1]
    path = []
    if segs[:1] == ["model"]:
        if len(segs) > 2 and segs[2].isdigit():
            path.append(f"model_{segs[1]}_{segs[2]}")
            segs = segs[3:]
        else:
            path.append(f"model_{segs[1]}")
            segs = segs[2:]
    i = 0
    while i < len(segs):
        if segs[i] in ("m", "layer") and i + 1 < len(segs) and segs[i + 1].isdigit():
            path.append(f"m_{segs[i + 1]}" if segs[i] == "m" else f"block{segs[i + 1]}")
            i += 2
        else:
            path.append(segs[i])
            i += 1
    return tuple(path), leaf


@torch.no_grad()
def flax_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Set every parameter and BatchNorm statistic of `model` (a port model
    built from a config) to the value JAX's `model.init()` under
    `jax.random.PRNGKey(seed)` gives it, in place. Raises for a
    parameterised module this does not know."""
    from yolo_dual_tpu_torch.models.model import initialize_detect_biases
    from yolo_dual_tpu_torch.nn.common import C3SPP, C3TR, Sum
    from yolo_dual_tpu_torch.nn.dcn import C2f_DCN, DCNv2
    from yolo_dual_tpu_torch.nn.torchvision_backbones import ConvNeXtBlock
    root = (0, int(seed))  # jax.random.PRNGKey(seed) for 0 <= seed < 2**32
    owners, inner = {}, {}
    for mname, mod in model.named_modules():
        if isinstance(mod, (C3TR, C3SPP)):  # their inner block `m` is JAX's m_tr / m_spp
            inner[f"{mname}.m."] = f"{mname}.{'m_tr' if isinstance(mod, C3TR) else 'm_spp'}."
        for pname, p in mod.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = (mod, pname, p)
    for name, (mod, pname, p) in owners.items():
        scoped = next((name.replace(k, v, 1) for k, v in inner.items() if name.startswith(k)),
                      name)
        path, leaf = jax_scope(scoped)
        dev = p.device
        norm = isinstance(mod, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm))
        if norm or pname == "bias":
            p.fill_(1.0 if (pname == "weight" and norm) else 0.0)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):  # (k, k, c2, c1) for the latter
            if path[-1] == "conv_offset_mask":  # DCNv2's offset and mask head
                p.zero_()
            else:
                hwio = (*p.shape[2:], p.shape[1], p.shape[0])
                p.copy_(lecun_normal(param_key(path, 1, root), hwio, dev).permute(3, 2, 0, 1))
        elif isinstance(mod, nn.Linear):
            p.copy_(lecun_normal(param_key(path, 1, root), (p.shape[1], p.shape[0]), dev).t())
        elif isinstance(mod, Sum) and pname == "w":
            p.copy_(-torch.arange(1.0, p.numel() + 1) / 2)
        elif isinstance(mod, ConvNeXtBlock) and pname == "gamma":
            p.fill_(1e-6)
        elif isinstance(mod, DCNv2) and pname == "weight":
            std = 1.0 / math.sqrt(p.shape[1] * mod.g * p.shape[2] * p.shape[3])
            hwio = (*p.shape[2:], p.shape[1], p.shape[0])
            p.copy_(uniform(param_key(path, 1, root), hwio, -std, std, dev).permute(3, 2, 0, 1))
        elif isinstance(mod, C2f_DCN) and pname.endswith("_dcn_weight"):
            i = int(pname.split("_")[1])
            hwio = (*p.shape[2:], p.shape[1], p.shape[0])
            p.copy_(lecun_normal(param_key(path, i + 1, root), hwio, dev).permute(3, 2, 0, 1))
        else:
            raise NotImplementedError(f"{name}: JAX's initializer of {type(mod).__name__}."
                                      f"{pname} is not reproduced")
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats:
            m.reset_running_stats()
    if isinstance(getattr(model, "model", None), nn.ModuleList):
        initialize_detect_biases(model)
    return model
