"""Weights in: the port's orbax reader (yolo_dual_tpu_torch/io/ocdbt.py)
against orbax's own restore, the weights rule and the entry points that take
an orbax directory against the JAX package's, MultiBackend and Ensemble
against JAX's, and the committed fixture that chip_smoke.py serves on the
card.

Checkpoints are written by JAX's save_checkpoint (orbax). Tolerances: the
reader is bit for bit against orbax (a bfloat16 leaf against orbax's value
widened to float32, which is exact); forwards of the same weights 1e-4 (JAX
and the port sum in other orders), the fused ones against JAX's unfused
forward too; where a test mirrors a JAX test, that test's tolerance, named
beside it.
"""

import ctypes
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from detection_matching import pair_detections
from test_torch_port_data import loaders, relabel_with_model, write_dataset
from test_torch_port_semantic import (json_set, narrow_calibrated_cli,  # noqa: F401 (fixture)
                                      predict_cli_matches_jax)
from test_torch_port_serve import _zero_init, bodies, jax_serve_module, jax_server, request, serving
from torch_port_common import (IMGSZ, ORBAX_FIXTURE, TINY_NC, TINY_NM, TINY_SEG,
                               flax_from_state_dict, narrow_semantic, orbax_fixture_cfg, port_model,
                               primed_tiny, random_variables, write_yolo_split)
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu.io.ensemble import attempt_load as jax_attempt_load
from yolo_dual_tpu.io.weights import resolve_variables
from yolo_dual_tpu.models import model as jax_model
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.train import load_checkpoint as jax_load_checkpoint
from yolo_dual_tpu.train import save_checkpoint
from yolo_dual_tpu.train.checkpoint import export_torch_state_dict
from yolo_dual_tpu.train.checkpoint import partial_load as jax_partial_load
from yolo_dual_tpu.train.checkpoint import strip_optimizer as jax_strip_optimizer
from yolo_dual_tpu.train.optim import smart_optimizer
from yolo_dual_tpu_torch import serve as port_serve
from yolo_dual_tpu_torch.io import ocdbt
from yolo_dual_tpu_torch.io.ensemble import Ensemble, attempt_load
from yolo_dual_tpu_torch.io.multibackend import MultiBackend, detect_kind
from yolo_dual_tpu_torch.io.onnx_export import export_onnx
from yolo_dual_tpu_torch.io.weights import (orbax_variables, resolve_state_dict,
                                            state_dict_from_flax, state_dict_from_orbax)
from yolo_dual_tpu_torch.models.model import SegmentationModel, SemanticSegModel
from yolo_dual_tpu_torch.segment import train as seg_train
from yolo_dual_tpu_torch.segment import val as val_cli
from yolo_dual_tpu_torch.segment.predict import run as seg_predict_run
from yolo_dual_tpu_torch.train.checkpoint import partial_load

TOL = dict(rtol=1e-4, atol=1e-4)


def assert_same_tree(want, got, path=""):
    """`got` (the port's reader) equals `want` (orbax's restore) bit for bit:
    the same containers (orbax gives lists for tuples and dicts for named
    tuples), Python scalars of the same type, arrays of the same dtype, shape
    and bytes; a bfloat16 leaf is read as the float32 of its value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got)
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), (path, got)
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same_tree(w, g, f"{path}/{i}")
    elif want is None or isinstance(want, (bool, int, float, str)):
        assert type(got) is type(want) and got == want, (path, want, got)
    else:
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        assert isinstance(got, np.ndarray), (path, type(got))
        assert (got.dtype, got.shape) == (w.dtype, w.shape), (path, got.dtype, w.dtype)
        assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(w).tobytes(), path


def trainer_tree(fused=True, seed=3):
    """The JAX trainers' checkpoint layout (segment/train.py:280-282) for the
    primed TINY_SEG: variables, ema {ema, updates}, the optimizer state of
    train/optim.py:smart_optimizer (fused: one momentum vector; unfused:
    optax's chains of named tuples), epoch, best_fitness."""
    _, v = primed_tiny()
    rng = np.random.default_rng(seed)
    ema = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype), v)
    tx = smart_optimizer(v["params"], "SGD", {"lr0": 0.01, "momentum": 0.9,
                                              "weight_decay": 5e-4}, epochs=2,
                         steps_per_epoch=2, fused=fused)
    return {"variables": v, "ema": {"ema": ema, "updates": np.int32(7)},
            "opt_state": tx.init(v["params"]), "epoch": 4, "best_fitness": 0.5}


def dtypes_tree():
    rng = np.random.default_rng(4)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "bf16": jnp.asarray(rng.normal(size=(2, 9)), jnp.bfloat16),
        "f64": rng.normal(size=(5,)), "f16": rng.normal(size=(6,)).astype(np.float16),
        "i8": np.arange(-4, 4, dtype=np.int8), "u8": np.arange(250, 256, dtype=np.uint8),
        "i32": np.arange(5, dtype=np.int32), "i64": np.arange(-3, 3, dtype=np.int64),
        "bool": np.array([True, False, True]), "zero_d": np.array(2.5, np.float32),
        "scalars": {"int": 3, "float": 0.25, "bool": True, "np_int": np.int32(-7),
                    "np_float": np.float32(1.5)},
        "none": None, "strings": ["a", "bcd"], "tuple": (np.float32(1.5), 2, [None, 4.0]),
        "empty": {}, "nested": {"a": {"b": {"c": np.ones((2, 2), np.float32)}}},
    }


def chunked_tree():
    """jax.Arrays sharded over the 8 CPU devices (tests/conftest.py): orbax
    writes a chunk a shard, so each spans several chunks; and numpy arrays
    large enough that the store keeps them outside its B-tree nodes."""
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("a", "b"))
    rng = np.random.default_rng(5)

    def put(shape, spec):
        return jax.device_put(jnp.asarray(rng.normal(size=shape).astype(np.float32)),
                              NamedSharding(mesh, PartitionSpec(*spec)))
    return {"rows": put((64, 40), ("a",)), "cols": put((16, 24), (None, "b")),
            "both": put((6, 8, 5), ("a", "b")), "big": rng.normal(size=(300, 301)).astype(np.float32),
            "big_i32": rng.integers(-9, 9, (2000,), dtype=np.int32)}


@pytest.mark.parametrize("case", ["trainer", "trainer_optax_chain", "dtypes", "chunked"])
def test_reader_equals_orbax_restore(tmp_path, case):
    tree = {"trainer": trainer_tree, "trainer_optax_chain": lambda: trainer_tree(fused=False),
            "dtypes": dtypes_tree, "chunked": chunked_tree}[case]()
    path = save_checkpoint(tmp_path / "ckpt", tree)
    want = jax_load_checkpoint(path)
    assert_same_tree(want, ocdbt.load_checkpoint(path))
    ckpt = ocdbt.OrbaxCheckpoint(path)
    for key in want:  # every subtree alone
        assert_same_tree(want[key], ckpt.read(key))
    if case == "chunked":
        sizes = {}  # each array's chunks
        for key, ref in ckpt.store.entries().items():
            name, chunk = key.decode().split("/")
            if chunk != ".zarray":
                sizes.setdefault(name, []).append(ref)
        assert min(len(sizes[k]) for k in ("rows", "cols", "both")) >= 2, sizes
        assert ref_kinds(sizes["big"]) == {"file"}  # past the inline limit: a data file span


def ref_kinds(refs):
    return {"inline" if r[0] == "inline" else "file" for r in refs if r}


def test_read_decodes_only_the_subtree_asked(tmp_path, monkeypatch):
    """Loading weights reads the EMA's leaves and never decodes opt_state."""
    path = save_checkpoint(tmp_path / "ckpt", trainer_tree())
    names = []
    real = ocdbt.read_zarr
    monkeypatch.setattr(ocdbt, "read_zarr", lambda s, e, name: names.append(name) or real(s, e, name))
    ema = ocdbt.OrbaxCheckpoint(path).read("ema/ema")
    assert names and all(n.startswith("ema.ema.") for n in names)
    assert_same_tree(jax_load_checkpoint(path)["ema"]["ema"], ema)
    names.clear()
    state_dict_from_orbax(path)
    assert names and all(n.startswith("ema.ema.") for n in names)


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("dtype", ["<f4", "bfloat16", "<i2"])
def test_zarr_chunks_in_c_and_f_order(tmp_path, order, dtype):
    """read_zarr on arrays tensorstore writes into an OCDBT store: C and F
    order inside a chunk, edge chunks stored whole, chunks of only the fill
    value left out of the store (read as the fill value), zstd levels 1 and 9."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(6)
    want = (rng.normal(size=(13, 7, 5)) * 50).astype(np.float32)
    want[:4, :3] = 0  # one whole chunk of zeros, which the store omits
    ml = pytest.importorskip("ml_dtypes") if dtype == "bfloat16" else None
    cast = want.astype(ml.bfloat16) if ml else want.astype(np.dtype(dtype))
    for level, name in ((1, "lo"), (9, "hi")):
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}",
                                                  "path": f"{name}/"},
                     "metadata": {"shape": [13, 7, 5], "chunks": [4, 3, 5], "dtype": dtype,
                                  "order": order, "fill_value": 0,
                                  "compressor": {"id": "zstd", "level": level}}},
                    create=True).result()
        t[...] = cast
    store = ocdbt.OcdbtStore(tmp_path)
    entries = store.entries()
    assert f"lo/0.0.0".encode() not in entries and f"lo/3.2.0".encode() in entries
    exact = cast.astype(np.float32) if ml else cast
    for name in ("lo", "hi"):
        got = ocdbt.read_zarr(store, entries, name)
        assert got.dtype == exact.dtype and got.tobytes() == np.ascontiguousarray(exact).tobytes()


def test_btree_interior_nodes_and_key_prefix(tmp_path):
    """A store of 300 keys in B-tree nodes of at most 1 KiB (root height 2;
    values inline up to 64 bytes, in data files past it), written by
    tensorstore: every key and value equals tensorstore's, and a key prefix
    keeps exactly its keys."""
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 1024,
                                     "max_inline_value_bytes": 64}}).result()
    for i in range(300):
        kv[f"key{i:04d}/abc"] = (b"v%d," % i) * (1 + i % 40)
    store = ocdbt.OcdbtStore(tmp_path)
    assert store._root[3] >= 1
    entries = store.entries()
    keys = list(kv.list().result())
    assert sorted(entries) == sorted(keys) and len(keys) == 300
    assert all(store.value(entries[k]) == kv[k] for k in keys)
    assert ref_kinds(entries.values()) == {"inline", "file"}
    sub = store.entries(b"key01")
    assert sorted(sub) == [f"key{i:04d}/abc".encode() for i in range(100, 200)]
    assert store.entries(b"nokey") == {}


def test_zstd_decoder_against_zstandard():
    """The libzstd decoder on frames zstandard writes: levels -5 to 19, with
    and without the content size in the header (most of the fixture's
    B-tree nodes record none), several frames in a row."""
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(7)
    data = (rng.normal(size=70_000).astype(np.float32).tobytes()
            + bytes(20_000) + rng.integers(0, 4, 50_000, dtype=np.uint8).tobytes())
    dec = ocdbt._zstd()
    for level in (-5, 1, 3, 9, 19):
        for with_size in (True, False):
            frame = zstandard.ZstdCompressor(level=level, write_content_size=with_size).compress(data)
            assert dec.decompress(frame) == data
            assert dec.decompress(frame, len(data)) == data
    two = zstandard.ZstdCompressor(level=3).compress(data[:1000]) + \
        zstandard.ZstdCompressor(level=3).compress(data[1000:3000])
    assert dec.decompress(two, 3000) == data[:3000]
    with pytest.raises(ValueError, match="zstd"):
        dec.decompress(b"\x28\xb5\x2f\xfd garbage", 100)


def test_missing_zstd_library_names_it(monkeypatch):
    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")
    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match="libzstd.so.1"):
        ocdbt._Zstd()


def test_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        ocdbt.OrbaxCheckpoint(tmp_path)
    path = save_checkpoint(tmp_path / "ckpt", {"a": np.ones(3, np.float32)})
    with pytest.raises(KeyError, match="nothing under"):
        ocdbt.OrbaxCheckpoint(path).read("b")
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "manifest.ocdbt").write_bytes(b"\x00" * 40)
    with pytest.raises(ValueError, match="not an OCDBT record"):
        ocdbt.OcdbtStore(tmp_path / "bad")


# ---------------------------------------------------------------------------
# the weights rule and the entry points
# ---------------------------------------------------------------------------

def tiny_other(seed=5):
    jm = JaxSegmentationModel(TINY_SEG)
    return random_variables(lambda k, x: jm.module.init(k, x, train=False),
                            (1, IMGSZ, IMGSZ, 3), seed=seed)


@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    """Orbax checkpoints of the TINY_SEG weights in each layout
    resolve_variables reads: the EMA (the primed weights) beside other
    variables; variables with ema None; variables with an empty EMA; a bare
    variables tree."""
    root = tmp_path_factory.mktemp("orbax")
    jm, v = primed_tiny()
    other = tiny_other()
    layouts = {
        "ema": {"variables": other, "ema": {"ema": v, "updates": np.int32(3)}, "epoch": 1,
                "opt_state": {"mu": np.zeros(4, np.float32)}},
        "variables": {"variables": v, "ema": None, "epoch": 1},
        "empty_ema": {"variables": v, "ema": {"ema": {}, "updates": np.int32(0)}},
        "bare": v,
    }
    return jm, v, other, {k: save_checkpoint(root / k, t) for k, t in layouts.items()}


@pytest.mark.parametrize("layout", ["ema", "variables", "empty_ema", "bare"])
def test_orbax_variables_follow_jax_rule(tiny_checkpoints, layout):
    jm, v, _, paths = tiny_checkpoints
    want = resolve_variables(jm, paths[layout], None)
    got = orbax_variables(paths[layout])
    assert_same_tree(want, got)
    assert_same_tree(v, got)  # the primed weights in each layout
    assert {k: t.shape for k, t in state_dict_from_orbax(paths[layout]).items()} == \
        {k: t.shape for k, t in port_model(v).state_dict().items()}


def test_resolved_state_dict_gives_jax_outputs(tiny_checkpoints, tmp_path):
    """resolve_state_dict of an orbax directory and of the `.pt` JAX's
    export_torch_state_dict writes, loaded strictly, give JAX's forward on the
    resolved variables (mirrors tests/test_io_roundtrip.py:37)."""
    jm, v, _, paths = tiny_checkpoints
    x = np.random.default_rng(8).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(resolve_variables(jm, paths["ema"], None), jnp.asarray(x), train=False)
    pt = tmp_path / "w.pt"
    torch.save({"model": {k: torch.tensor(a) for k, a in
                          export_torch_state_dict(v, jm.spec).items()}}, pt)
    for weights in (paths["ema"], pt):
        model = SegmentationModel(TINY_SEG, device="cpu")
        model.load_state_dict(resolve_state_dict(weights), strict=True)
        with torch.no_grad():
            pred, protos, _ = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(pred.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), np.asarray(want[1]), **TOL)


def test_segment_val_from_orbax_matches_jax(tiny_checkpoints, tmp_path, monkeypatch):
    """segment.val.run with --weights an orbax directory (EMA beside other
    variables) against JAX's segment/val.py:46 load_model_and_weights on the
    same directory and evaluate_segment; the metrics within 1e-4, as
    tests/test_torch_port_data.py holds the `.pt` route."""
    _, v, _, paths = tiny_checkpoints
    root = write_dataset(tmp_path, n=5)
    relabel_with_model(root, v)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY_SEG))
    (tmp_path / "tiny.json").write_text(json.dumps(TINY_SEG))
    jax_serve_module()  # loads JAX's segment/val.py as jax_segment_val_vs_port
    import sys
    jval = sys.modules["jax_segment_val_vs_port"]
    monkeypatch.setattr(jax_model.BaseModel, "init", _zero_init)
    jm, jv = jval.load_model_and_weights(str(paths["ema"]), str(tmp_path / "tiny.yaml"), TINY_NC,
                                         IMGSZ)
    jl, _ = loaders(root, bs=2)
    jl.dataset.max_labels = 120
    want, want_maps, _ = jax_evaluate_segment(jm, jv, jl, TINY_NC, conf_thres=0.001,
                                              iou_thres=0.6, nm=TINY_NM)
    got, got_maps, _ = val_cli.run(data=str(root / "port"), weights=str(paths["ema"]),
                                   cfg=str(tmp_path / "tiny.json"), batch_size=2, imgsz=IMGSZ,
                                   device="cpu", device_preprocess=True)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05 and got[6] > 0.05, got


def test_serve_from_orbax_matches_jax(tiny_checkpoints, tmp_path):
    """JAX's root serve.py and the port's serve.py, both from the same orbax
    directory: the same detections, paired by tests/detection_matching.py as
    tests/test_torch_port_serve.py pairs them."""
    _, _, _, paths = tiny_checkpoints
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY_SEG))
    (tmp_path / "tiny.json").write_text(json.dumps(TINY_SEG))
    common = ["--weights", str(paths["ema"]), "--nc", str(TINY_NC), "--imgsz", str(IMGSZ),
              "--port", "0"]
    jax_srv = jax_server(["--cfg", str(tmp_path / "tiny.yaml")] + common)
    port_srv = port_serve.build_server(port_serve.parse_opt(
        ["--cfg", str(tmp_path / "tiny.json"), "--device", "cpu"] + common))
    n_rows = 0
    with serving(jax_srv, port_srv) as (jax_url, port_url):
        for name, body in list(bodies(4).items())[:6]:
            want = json.loads(request(jax_url, "/predict", body)[1])["detections"]
            got = json.loads(request(port_url, "/predict", body)[1])["detections"]
            w = np.array([[*d["box"], d["conf"], d["cls"]] for d in want], np.float64).reshape(-1, 6)
            g = np.array([[*d["box"], d["conf"], d["cls"]] for d in got], np.float64).reshape(-1, 6)
            _, ties, left_w, left_g = pair_detections(w, g, conf_thres=0.25, box_tol=1e-3,
                                                      conf_tol=1e-5)
            assert len(g) == len(w) and not len(left_w) and not len(left_g), (name, ties)
            n_rows += len(w)
    assert n_rows > 10


def test_semantic_predict_from_orbax_matches_jax(json_set, tmp_path_factory, tmp_path,
                                                 monkeypatch):
    """semantic.predict.run and JAX's root semantic/predict.py, both given
    the same orbax directory (the calibrated narrow resnet50 as its EMA,
    other variables beside it): the masks, overlays and panels by the rule of
    tests/test_torch_port_semantic.py (equal but at JAX's near ties)."""
    jm, scores, v, cfg, _, _ = narrow_calibrated_cli("resnet50", json_set, tmp_path_factory)
    other = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, v)
    ckpt = save_checkpoint(tmp_path / "ckpt", {"variables": other,
                                               "ema": {"ema": v, "updates": np.int32(2)}})
    (tmp_path / "out").mkdir()
    predict_cli_matches_jax(json_set, (jm, scores, v, cfg, ckpt, ckpt), tmp_path / "out",
                            monkeypatch)


def test_segment_train_takes_variables_not_the_ema(tiny_checkpoints, tmp_path, monkeypatch):
    """segment.train --weights <orbax dir> starts from ckpt["variables"] as
    JAX's segment/train.py:120-125 does, not from the EMA that the val and
    predict CLIs take; a `.pt` keeps its partial load."""
    _, v, other, paths = tiny_checkpoints
    data = write_yolo_split(tmp_path / "data", "train", 2, ((48, 64),), seed=1)
    (tmp_path / "tiny.json").write_text(json.dumps(TINY_SEG))
    built = []

    class Capture(SegmentationModel):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop
    monkeypatch.setattr(seg_train, "SegmentationModel", Capture)
    monkeypatch.setattr(seg_train, "create_dataloader", stop)
    opt = seg_train.parse_opt(["--cfg", str(tmp_path / "tiny.json"), "--data", str(data / "port"),
                               "--weights", str(paths["ema"]), "--device", "cpu", "--imgsz",
                               str(IMGSZ), "--project", str(tmp_path / "runs")])
    with pytest.raises(Stop):
        seg_train.train(opt)
    got = built[-1].state_dict()
    for k, t in state_dict_from_flax(other).items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    assert not torch.equal(got["model.0.conv.weight"], state_dict_from_flax(v)["model.0.conv.weight"])


def test_semantic_partial_load_equals_jax(tmp_path):
    """train/checkpoint.py:partial_load from an orbax directory (the
    semantic.train --weights route) against JAX's partial_load: the EMA's
    leaves whose shapes match, the others left; here a checkpoint of the
    narrow resnet18 at 5 classes loaded into one at 12, so the classifier
    rows stay."""
    d12, d5 = narrow_semantic("resnet18", 8), narrow_semantic("resnet18", 8)
    d5["nc"] = 5
    j12, j5 = JaxSemanticSegModel(d12), JaxSemanticSegModel(d5)
    v12 = random_variables(lambda k, x: j12.module.init(k, x, train=False), (1, 64, 64, 3), 1)
    v5 = random_variables(lambda k, x: j5.module.init(k, x, train=False), (1, 64, 64, 3), 2)
    other = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0, v5)
    ckpt = save_checkpoint(tmp_path / "ckpt", {"variables": other, "ema": {"ema": v5}})
    want = jax_partial_load(v12, ckpt)
    model = SemanticSegModel(d12, device="cpu")
    model.load_state_dict(state_dict_from_flax(v12), strict=True)
    partial_load(model, ckpt)
    got = model.state_dict()
    taken = 0
    for k, t in state_dict_from_flax(want).items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
        taken += not torch.equal(t, state_dict_from_flax(v12)[k])
    assert 0 < taken < len(got)


def test_classify_val_and_predict_from_orbax_match_jax(tmp_path):
    """classify.val and classify.predict given an orbax directory (the
    classifier's EMA beside other variables, and `classes`) against JAX's
    root classify/val.py and predict.py on the same directory: top-1 / top-5
    equal, the top-k classes equal, probabilities within 1e-5, the --save-txt
    rows the same (tests/test_torch_port_classify_cli.py's rule for `.pt`)."""
    from test_torch_port_classify_cli import jax_script, make_imageset
    from yolo_dual_tpu_torch.classify import predict as cls_predict
    from yolo_dual_tpu_torch.classify import val as cls_val
    from yolo_dual_tpu_torch.classify.train import build_classifier
    from yolo_dual_tpu_torch.models.flax_init import flax_init_
    root = make_imageset(tmp_path / "set", n_per_class=6, size=32)
    jm = jax_script("train").build_classifier(str(root / "mini.yaml"), 3, cutoff=2)
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), jax.eval_shape(
        lambda k, x: jm.module.init(k, x, train=False), jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)))
    model = flax_init_(build_classifier(str(root / "mini.json"), 3, cutoff=2, device="cpu"))
    ema = {k: t * 1.5 for k, t in model.state_dict().items()}
    ckpt = save_checkpoint(tmp_path / "ckpt", {
        "variables": flax_from_state_dict(template, model.state_dict()),
        "ema": {"ema": flax_from_state_dict(template, ema), "updates": np.int32(9)},
        "classes": ["blue", "green", "red"]})
    common = dict(imgsz=32, cutoff=2, batch_size=8)
    want = jax_script("val").run(weights=str(ckpt), model=str(root / "mini.yaml"),
                                 data_dir=str(root / "jax"), **common)
    got = cls_val.run(weights=str(ckpt), model=str(root / "mini.json"),
                      data_dir=str(root / "port"), device="cpu", **common)
    assert got == tuple(float(w) for w in want)
    pkw = dict(imgsz=32, cutoff=2, topk=3, save_txt=True, exist_ok=True, project=str(tmp_path))
    want = jax_script("predict").run(weights=str(ckpt), model=str(root / "mini.yaml"),
                                     source=str(root / "jax" / "val" / "red"), name="jax", **pkw)
    got = cls_predict.run(weights=str(ckpt), model=str(root / "mini.json"), nosave=True,
                          source=str(root / "port" / "val" / "red"), name="port", device="cpu",
                          **pkw)
    assert len(got) == len(want) == 4
    for (_, go, gprob), (_, wo, wprob) in zip(got, want):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_allclose(gprob, wprob, atol=1e-5)
    for i in range(4):
        assert (tmp_path / "port" / "labels" / f"{i}.txt").read_text() \
            == (tmp_path / "jax" / "labels" / f"{i}.txt").read_text()
    # --update on the directory: stripped as JAX's classify/predict.py strips it
    # (its strip_optimizer), then the same predictions from the EMA now in `variables`
    for side in ("jax", "port"):
        shutil.copytree(ckpt, tmp_path / f"upd_{side}")
    jax_strip_optimizer(tmp_path / "upd_jax")
    again = cls_predict.run(weights=str(tmp_path / "upd_port"), model=str(root / "mini.json"),
                            update=True, source=str(root / "port" / "val" / "red"),
                            device="cpu", nosave=True, imgsz=32, cutoff=2, topk=3)
    assert_same_tree(jax_load_checkpoint(tmp_path / "upd_jax"),
                     ocdbt.load_checkpoint(tmp_path / "upd_port"))
    for (_, go, gprob), (_, wo, wprob) in zip(again, got):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gprob, wprob)


def test_predict_update_on_orbax_names_its_roadmap_item(tiny_checkpoints, tmp_path):
    """segment.predict --update on an orbax directory (formerly refused,
    ROADMAP A item 7e): the directory is stripped as JAX's segment/predict.py
    strips it (its strip_optimizer: the EMA into `variables`, opt_state and
    ema None, epoch -1), then the rows predicted from it are those of the
    unstripped directory's EMA."""
    _, _, _, paths = tiny_checkpoints
    for side in ("jax", "port"):
        shutil.copytree(paths["ema"], tmp_path / side)
    frame = np.random.default_rng(5).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    np.save(tmp_path / "frame.npy", frame)
    kw = dict(cfg=TINY_SEG, source=str(tmp_path / "frame.npy"), imgsz=IMGSZ, conf_thres=0.01,
              nosave=True, device="cpu", nc=TINY_NC)
    want = seg_predict_run(weights=str(paths["ema"]), **kw)
    jax_strip_optimizer(tmp_path / "jax")
    got = seg_predict_run(weights=str(tmp_path / "port"), update=True, **kw)
    assert_same_tree(jax_load_checkpoint(tmp_path / "jax"), ocdbt.load_checkpoint(tmp_path / "port"))
    assert ocdbt.load_checkpoint(tmp_path / "port", "epoch") == -1
    assert len(got) == len(want) == 1 and len(got[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# MultiBackend and Ensemble
# ---------------------------------------------------------------------------

def test_multibackend_kind_detection(tmp_path):
    """Mirrors tests/test_io_roundtrip.py:180."""
    (tmp_path / "sm").mkdir()
    (tmp_path / "sm" / "saved_model.pb").touch()
    assert detect_kind(tmp_path / "sm") == "savedmodel"
    (tmp_path / "ck").mkdir()
    assert detect_kind(tmp_path / "ck") == "orbax"
    assert detect_kind(tmp_path / "w.pt") == "torchpt"
    assert detect_kind(tmp_path / "w.tflite") == "tflite"
    assert detect_kind(tmp_path / "w.torchscript") == "torchscript"
    assert detect_kind(tmp_path / "w.onnx") == "onnx"
    with pytest.raises(ValueError):
        detect_kind(tmp_path / "missing.bin")


def test_multibackend_torchpt_and_orbax(tmp_path):
    """Mirrors tests/test_io_roundtrip.py:72: a `.pt` of JAX's export, unfused
    equal to JAX's forward, fused too (1e-4 here, where JAX's test allows
    5e-2); and the same weights from an orbax directory."""
    cfg = dict(nc=2, depth_multiple=1.0, width_multiple=1.0, anchors=[[10, 13, 16, 30, 33, 23]],
               backbone=[[-1, 1, "Conv", [8, 6, 2, 2]], [-1, 1, "Conv", [16, 3, 2]],
                         [-1, 1, "Conv", [16, 3, 2]]],
               head=[[[2], 1, "Segment", ["nc", "anchors", 4, 8]]])
    jm = JaxSegmentationModel(cfg)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 32, 32, 3), 9)
    pt = tmp_path / "w.pt"
    torch.save({"model": {k: torch.tensor(a) for k, a in export_torch_state_dict(v, jm.spec).items()}},
               pt)
    ck = save_checkpoint(tmp_path / "ck", {"variables": v})
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref_pred, ref_protos, _ = jm.apply(v, jnp.asarray(x), train=False)
    for weights, fuse in ((pt, False), (pt, True), (ck, True)):
        mb = MultiBackend(weights, cfg=cfg, nc=2, imgsz=32, fuse=fuse, device="cpu")
        assert mb.kind == ("torchpt" if weights == pt else "orbax")
        pred, protos = mb(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), **TOL)
        np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), np.asarray(ref_protos), **TOL)
    with pytest.raises(ValueError, match="cfg is required"):
        MultiBackend(pt)


def test_multibackend_detect_head_protos_none(tmp_path):
    """Mirrors tests/test_io_roundtrip.py:126 (its tolerance: rtol 1e-3, atol
    2e-4): a Detect head's raw levels do not leak through the protos slot,
    and a `model_state_dict` container unwraps as JAX's torch import unwraps
    it (the port's reader skipped that key before; ROADMAP §C, C4)."""
    cfg = dict(nc=2, depth_multiple=1.0, width_multiple=1.0,
               anchors=[[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
               backbone=[[-1, 1, "Conv", [8, 6, 2, 2]], [-1, 1, "Conv", [16, 3, 2]],
                         [-1, 1, "C3", [16]], [-1, 1, "Conv", [24, 3, 2]], [-1, 1, "SPPF", [24, 5]]],
               head=[[[3, 4], 1, "Detect", ["nc", "anchors"]]])
    jm = jax_model.SegmentationModel(cfg)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), 10)
    w = tmp_path / "detect.pt"
    torch.save({"model_state_dict": {k: torch.tensor(a) for k, a in
                                     export_torch_state_dict(v, jm.spec).items()}}, w)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    pred, protos = MultiBackend(w, cfg=str(tmp_path / "cfg.json"), nc=2, imgsz=64,
                                device="cpu")(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert protos is None and pred.ndim == 3
    np.testing.assert_allclose(pred.numpy(), np.asarray(jm.apply(v, jnp.asarray(x), train=False)[0]),
                               rtol=1e-3, atol=2e-4)


def test_multibackend_torchscript(tmp_path):
    """Mirrors tests/test_io_roundtrip.py:105."""
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 1)

        def forward(self, x):
            return self.conv(x).flatten(2).transpose(1, 2)  # (b, hw, 4)

    ts = tmp_path / "w.torchscript"
    torch.jit.script(Tiny()).save(str(ts))
    mb = MultiBackend(ts, imgsz=16, device="cpu")
    assert mb.kind == "torchscript"
    pred, protos = mb.warmup((1, 3, 16, 16)).forward(torch.ones(1, 3, 16, 16))
    assert pred.shape == (1, 256, 4) and protos is None


def test_multibackend_onnx(tmp_path):
    """Mirrors tests/test_onnx_export.py:70 (its tolerances: pred atol 2e-3 /
    rtol 1e-3, protos 1e-3): the port's ONNX file through cv2.dnn against
    JAX's forward of the same weights."""
    pytest.importorskip("cv2")
    from test_torch_parity import tiny_cfg
    jm = JaxSegmentationModel(tiny_cfg(True), nc=4)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), 11)
    model = SegmentationModel(tiny_cfg(True), nc=4, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    path = export_onnx(model.eval(), 64, tmp_path / "m.onnx")
    mb = MultiBackend(path, imgsz=64)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    pred, protos = mb(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref_pred, ref_protos, _ = jm.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), np.asarray(ref_protos),
                               atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def tf_files(tmp_path_factory):
    """A SavedModel and a TFLite file of the primed TINY_SEG, written by the
    JAX package's export.py, and JAX's forward of a seeded frame."""
    import importlib.util
    tf = pytest.importorskip("tensorflow")
    from torch_port_common import ROOT
    spec = importlib.util.spec_from_file_location("jax_export_vs_port", ROOT / "export.py")
    jexport = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexport)
    jm, v = primed_tiny()
    root = tmp_path_factory.mktemp("tf")
    sm = jexport.export_savedmodel(jm, v, IMGSZ, root / "sm")
    fl = jexport.export_tflite(sm, root / "m.tflite", imgsz=IMGSZ)
    x = np.random.default_rng(12).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    pred, protos, _ = jm.apply(v, jnp.asarray(x), train=False)
    return tf, sm, fl, x, np.asarray(pred), np.asarray(protos)


@pytest.mark.parametrize("kind", ["savedmodel", "tflite"])
def test_multibackend_tensorflow_files_of_jax_export(tf_files, kind):
    """The files JAX's export.py writes, served by the port's MultiBackend
    through tensorflow: (pred, protos NCHW) against JAX's forward within
    tests/test_export.py's 1e-3."""
    _, sm, fl, x, want_pred, want_protos = tf_files
    mb = MultiBackend(sm if kind == "savedmodel" else fl)
    assert mb.kind == kind
    pred, protos = mb(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(pred.numpy(), want_pred, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), want_protos, rtol=1e-3,
                               atol=1e-3)


def test_multibackend_without_tensorflow_names_it(tmp_path, monkeypatch):
    import sys
    (tmp_path / "sm").mkdir()
    (tmp_path / "sm" / "saved_model.pb").touch()
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for w in (tmp_path / "sm", tmp_path / "m.tflite"):
        with pytest.raises(ImportError, match="tensorflow"):
            MultiBackend(w)


@pytest.mark.parametrize("mode", ["cat", "mean"])
def test_ensemble_matches_jax(tiny_checkpoints, tmp_path, monkeypatch, mode):
    """attempt_load of an orbax directory and a `.pt` against JAX's
    attempt_load of the same two: the merged predictions and the first
    member's protos within 1e-4."""
    jm, v, other, paths = tiny_checkpoints
    pt = tmp_path / "other.pt"
    torch.save({"model": {k: torch.tensor(a) for k, a in
                          export_torch_state_dict(other, jm.spec).items()}}, pt)
    monkeypatch.setattr(jax_model.BaseModel, "init", _zero_init)
    jens = jax_attempt_load([str(paths["ema"]), str(pt)], TINY_SEG, nc=TINY_NC, imgsz=IMGSZ,
                            mode=mode)
    ens = attempt_load([paths["ema"], pt], TINY_SEG, nc=TINY_NC, mode=mode, device="cpu")
    assert isinstance(ens, Ensemble) and ens.mode == mode and ens.nc == TINY_NC
    x = np.random.default_rng(13).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_pred, want_protos = jens(jnp.asarray(x))
    pred, protos = ens(torch.from_numpy(x).permute(0, 3, 1, 2))
    n = 3 * (8 * 8 + 4 * 4)
    assert pred.shape == (2, 2 * n if mode == "cat" else n, 5 + TINY_NC + TINY_NM)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), **TOL)
    np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), np.asarray(want_protos), **TOL)
    model, sd = attempt_load(str(pt), TINY_SEG, nc=TINY_NC, device="cpu")
    assert isinstance(model, SegmentationModel) and set(sd) <= set(model.state_dict())
    with pytest.raises(ValueError, match="mode"):
        Ensemble([model], mode="max")


# ---------------------------------------------------------------------------
# the fixture chip_smoke.py serves on the card
# ---------------------------------------------------------------------------

def test_fixture_reads_as_jax_reads_it():
    """The committed checkpoint: the port's reader equals JAX's
    load_checkpoint on every leaf; its config is orbax_fixture_cfg(); the
    trainers' layout."""
    ckpt = ORBAX_FIXTURE / "ckpt"
    want = jax_load_checkpoint(ckpt)
    assert set(want) == {"variables", "ema", "opt_state", "epoch", "best_fitness"}
    assert_same_tree(want, ocdbt.load_checkpoint(ckpt))
    assert json.loads((ORBAX_FIXTURE / "cfg.json").read_text()) == orbax_fixture_cfg()


def test_fixture_served_on_the_cpu_equals_jax_output():
    """MultiBackend of the committed checkpoint on the CPU against the
    committed output of JAX's MultiBackend (the EMA, conv+BN folded) within
    1e-4, the tolerance chip_smoke.py holds the card's run to."""
    mb = MultiBackend(ORBAX_FIXTURE / "ckpt", cfg=ORBAX_FIXTURE / "cfg.json", nc=80, imgsz=64,
                      device="cpu")
    x = torch.from_numpy(np.load(ORBAX_FIXTURE / "input.npy")).permute(0, 3, 1, 2).float() / 255
    pred, protos = mb(x)
    np.testing.assert_allclose(pred.numpy(), np.load(ORBAX_FIXTURE / "pred.npy"), **TOL)
    np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(),
                               np.load(ORBAX_FIXTURE / "protos.npy"), **TOL)


def test_fixture_rewrites_to_the_same_values(tmp_path):
    """write_orbax_fixture's checkpoint is reproducible: written anew, every
    leaf equals the committed one (orbax's files hold timestamps and ids, so
    the bytes differ)."""
    from torch_port_common import write_orbax_fixture
    shutil.copytree(ORBAX_FIXTURE, tmp_path / "committed")
    out = write_orbax_fixture(tmp_path / "new", forward=False)
    assert_same_tree(jax_load_checkpoint(tmp_path / "committed" / "ckpt"),
                     ocdbt.load_checkpoint(out / "ckpt"))
    np.testing.assert_array_equal(np.load(out / "input.npy"), np.load(ORBAX_FIXTURE / "input.npy"))
