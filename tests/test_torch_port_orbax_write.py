"""Weights out as orbax checkpoints: the port's writer
(yolo_dual_tpu_torch/io/ocdbt.py:save_checkpoint) and strip_optimizer
(yolo_dual_tpu_torch/train/checkpoint.py) against orbax 0.11's restore and
the JAX package's save_checkpoint / strip_optimizer.

The rule: orbax's PyTreeCheckpointer().restore of the port's directory
equals its restore of JAX's directory of the same tree, bit for bit (the
same containers, Python scalars of the same type, arrays of the same dtype,
shape and bytes); a leaf JAX writes as a jax.Array the port writes as a
numpy array, compared through np.asarray.
"""

import shutil

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from test_torch_port_io import dtypes_tree, trainer_tree
from test_torch_port_serve import _zero_init
from torch_port_common import ORBAX_FIXTURE
from yolo_dual_tpu.io.multibackend import MultiBackend as JaxMultiBackend
from yolo_dual_tpu.models import model as jax_model
from yolo_dual_tpu.train import load_checkpoint as jax_load_checkpoint
from yolo_dual_tpu.train import save_checkpoint as jax_save_checkpoint
from yolo_dual_tpu.train.checkpoint import strip_optimizer as jax_strip_optimizer
from yolo_dual_tpu_torch.io import ocdbt
from yolo_dual_tpu_torch.train.checkpoint import strip_optimizer

FIXTURE_CFG = ORBAX_FIXTURE / "cfg.json"


def same_restore(want, got, path=""):
    """Two orbax restores hold the same tree bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            same_restore(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got)
        for i, (w, g) in enumerate(zip(want, got)):
            same_restore(w, g, f"{path}/{i}")
    elif want is None or isinstance(want, (bool, int, float, str)):
        assert type(got) is type(want) and got == want, (path, want, got)
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (path, g.dtype, w.dtype, g.shape, w.shape)
        assert np.ascontiguousarray(g).tobytes() == np.ascontiguousarray(w).tobytes(), path


def numpy_tree(t):
    """jax.Arrays -> numpy arrays (a bfloat16 one stays bfloat16)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, t)


def orbax_restore(path):
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer().restore(path)


def sharded_tree():
    """A jax.Array over the 8 CPU devices (tests/conftest.py: JAX writes a
    chunk a shard) and arrays large enough to lie outside the B-tree node."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    big = np.arange(64 * 48, dtype=np.float32).reshape(64, 48)
    return {"sharded": jax.device_put(big, NamedSharding(mesh, PartitionSpec("a", "b"))),
            "big_i64": np.arange(5000, dtype=np.int64).reshape(50, 100),
            "wide": {str(i): np.full((300,), i, np.float32) for i in range(12)}}


TREES = {"dtypes": dtypes_tree, "trainer_fused": lambda: trainer_tree(True),
         "trainer_optax_chain": lambda: trainer_tree(False), "sharded": sharded_tree,
         "none_only": lambda: {"a": None, "b": {}, "c": []},
         "strings_only": lambda: {"name": "yolov5s", "classes": ["a", "b"]}}


@pytest.mark.parametrize("name", sorted(TREES))
def test_orbax_restores_the_port_write_as_jax_write(tmp_path, name):
    """Every leaf and container kind (each dtype JAX's trainers save,
    bfloat16 included, 0-d arrays, Python and numpy scalars, strings, None,
    empty dicts and lists, tuples), both optax state layouts, sharded and
    large arrays: orbax's restore of the port's directory equals its restore
    of JAX's, and the port's reader reads the port's directory as it reads
    JAX's."""
    tree = TREES[name]()
    want = orbax_restore(jax_save_checkpoint(tmp_path / "jax", tree))
    got_dir = ocdbt.save_checkpoint(tmp_path / "port", numpy_tree(tree))
    same_restore(want, orbax_restore(got_dir))
    same_restore(ocdbt.load_checkpoint(tmp_path / "jax"), ocdbt.load_checkpoint(got_dir))
    assert not (tmp_path / "port.orbax-checkpoint-tmp").exists()


def test_save_checkpoint_replaces_what_is_there(tmp_path):
    """As JAX's save_checkpoint (train/checkpoint.py:26-35): an existing
    checkpoint directory or a stray file at the path is replaced; a leaf orbax
    cannot save raises as orbax raises (ValueError on an array of zero size)
    and leaves the old checkpoint whole; other leaf types raise TypeError."""
    path = tmp_path / "ck"
    ocdbt.save_checkpoint(path, {"a": np.ones(3, np.float32), "old": 1})
    ocdbt.save_checkpoint(path, {"a": np.zeros(2, np.int32)})
    same_restore({"a": np.zeros(2, np.int32)}, orbax_restore(path))
    shutil.rmtree(path)
    path.write_text("stray")
    ocdbt.save_checkpoint(path, {"b": 2.5})
    assert orbax_restore(path) == {"b": 2.5}
    with pytest.raises(ValueError, match="zero size"):
        jax_save_checkpoint(tmp_path / "jax0", {"z": np.zeros((0, 3), np.float32)})
    with pytest.raises(ValueError, match="zero size"):
        ocdbt.save_checkpoint(path, {"z": np.zeros((0, 3), np.float32)})
    with pytest.raises(TypeError, match="object"):
        ocdbt.save_checkpoint(path, {"o": object()})
    assert orbax_restore(path) == {"b": 2.5}


def test_crc32c_and_zstd_round_trip():
    """CRC-32C's check value (RFC 3720: "123456789" -> 0xE3069283) and a
    zstd frame of ZSTD_compress read back by the reader's ZSTD_decompress."""
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(0).integers(0, 4, 10000, dtype=np.uint8).tobytes()
    frame = ocdbt._zstd().compress(data)
    assert len(frame) < len(data) and ocdbt._zstd().decompress(frame) == data


@pytest.fixture(scope="module")
def stripped(tmp_path_factory):
    """Two copies of the committed fixture, one stripped by JAX's
    strip_optimizer and one by the port's (in place), and a third stripped by
    the port to `out`."""
    root = tmp_path_factory.mktemp("strip")
    for name in ("jax", "port", "src"):
        shutil.copytree(ORBAX_FIXTURE / "ckpt", root / name)
    jax_strip_optimizer(root / "jax")
    strip_optimizer(root / "port")
    strip_optimizer(root / "src", out=str(root / "out"))
    return root


def test_strip_optimizer_matches_jax(stripped):
    """JAX's strip_optimizer and the port's of the same checkpoint: equal
    trees by orbax's restore (variables the EMA weights, opt_state and ema
    None, epoch -1, best_fitness kept); `out` leaves the source whole."""
    want = orbax_restore(stripped / "jax")
    assert want["opt_state"] is None and want["ema"] is None and want["epoch"] == -1
    for name in ("port", "out"):
        same_restore(want, orbax_restore(stripped / name))
    same_restore(orbax_restore(ORBAX_FIXTURE / "ckpt"), orbax_restore(stripped / "src"))
    same_restore(jax_load_checkpoint(ORBAX_FIXTURE / "ckpt")["ema"]["ema"],
                 ocdbt.load_checkpoint(stripped / "port", "variables"))


@pytest.mark.parametrize("layout", ["ema_none", "ema_flat", "ema_empty"])
def test_strip_optimizer_layouts_match_jax(tmp_path, layout):
    """JAX's rule on the other layouts: `ema` None keeps `variables`; an EMA
    without an `ema` key becomes `variables` whole; an empty EMA dict ({} is
    not None) replaces `variables` with {}."""
    v = {"params": {"w": np.arange(4, dtype=np.float32)}}
    ema = {"ema_none": None, "ema_flat": {"params": {"w": np.ones(4, np.float32)}},
           "ema_empty": {}}[layout]
    tree = {"variables": v, "ema": ema, "opt_state": [{"mu": np.zeros(4, np.float32)}, {}],
            "epoch": 3}
    jax_save_checkpoint(tmp_path / "jax", tree)
    ocdbt.save_checkpoint(tmp_path / "port", tree)
    jax_strip_optimizer(tmp_path / "jax")
    strip_optimizer(tmp_path / "port")
    same_restore(orbax_restore(tmp_path / "jax"), orbax_restore(tmp_path / "port"))


def test_jax_multibackend_serves_port_stripped_bit_equal(stripped, monkeypatch):
    """JAX's MultiBackend (the EMA-first weights rule, conv+BN folded) on
    the port-stripped directory and on the JAX-stripped one: bit-equal
    predictions and protos, and equal to the committed output of the
    unstripped checkpoint's EMA within 1e-4."""
    import json
    monkeypatch.setattr(jax_model.BaseModel, "init", _zero_init)
    cfg = json.loads(FIXTURE_CFG.read_text())
    x = np.load(ORBAX_FIXTURE / "input.npy").astype(np.float32) / 255
    outs = []
    with jax.default_matmul_precision("highest"):
        for name in ("jax", "port"):
            outs.append(JaxMultiBackend(stripped / name, cfg=cfg, nc=80, imgsz=64).forward(x))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(outs[1][0]), np.load(ORBAX_FIXTURE / "pred.npy"),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(outs[1][1]), np.load(ORBAX_FIXTURE / "protos.npy"),
                               rtol=1e-4, atol=1e-4)
