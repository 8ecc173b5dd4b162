"""The port's reading of reference `.pt` checkpoints against JAX's torch import.

Each case writes one `.pt` file in a layout of the reference from seeded
numpy variables (torch_port_common.random_variables), then reads it twice:
through JAX's `load_torch_checkpoint` + `import_torch_state_dict(spec=...)`
and through the port's `resolve_state_dict(path, model)`, and runs both
forwards on the same seeded numpy input. The outputs agree within 1e-5 of
each output's largest magnitude (at least 1).

JAX's import cannot read two leaf kinds of the reference (ROADMAP §C, known
and not faults): DCNv2's raw `weight` and a C3TR's nn.MultiheadAttention
with its joint `in_proj`. For those cases JAX's strict import raises, its
non-strict import fills every other leaf with the file's value, and the
leaves it leaves out (exactly those kinds) are taken from the variables the
file was written from.
"""

import re

import jax
import numpy as np
import pytest
import torch

from reference_layout import (forget_reference_tree, reference_state_dict, save_pickled_module,
                              write_reference_tree)
from torch_port_common import TINY_SEG, narrow_semantic, random_variables
from yolo_dual_tpu.io.torch_import import import_torch_state_dict as jax_import
from yolo_dual_tpu.io.torch_import import load_torch_checkpoint as jax_load
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu_torch.io.torch_import import (import_torch_state_dict, load_torch_checkpoint,
                                                 translate_torch_key)
from yolo_dual_tpu_torch.io.weights import resolve_state_dict, state_dict_from_flax
from yolo_dual_tpu_torch.models.model import SegmentationModel, SemanticSegModel

IMGSZ = 64
TOL = 1e-5

# A segment config with a row repeated as torch's nn.Sequential (model.2.{r}) and a
# C3TR, whose TransformerLayer the reference keeps as an nn.MultiheadAttention.
SEG_C3TR = dict(TINY_SEG, backbone=[
    [-1, 1, "Conv", [8, 6, 2, 2]],
    [-1, 1, "Conv", [16, 3, 2]],
    [-1, 2, "Bottleneck", [16]],
    [-1, 1, "Conv", [24, 3, 2]],
    [-1, 1, "C3TR", [24]],
    [-1, 1, "Conv", [32, 3, 2]],
], head=[[[4, 5], 1, "Segment", ["nc", "anchors", 4, 8]]])

# case: (config, width divisor or None, layout, leaves JAX's import cannot read)
CASES = {
    "resnet18": ("resnet18", 8, "state_dict", None),
    "vgg16": ("vgg16", 16, "state_dict", None),
    "yolov5_seg": ("yolov5_seg", 16, "state_dict", r"\.weight$"),  # DCNv2's raw weight
    "segment_c3tr": (SEG_C3TR, None, "state_dict", r"\.m_tr\."),
    "half_module": ("resnet18", 8, "half_module", None),
    "matches_nothing": ("resnet18", 8, "foreign", None),
}


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _segment(cfg):
    return not isinstance(cfg, str)


def _models(cfg, div):
    if _segment(cfg):
        jm = JaxSegmentationModel(cfg)
        return jm, cfg, SegmentationModel(cfg, device="cpu")
    d = narrow_semantic(cfg, div)
    return JaxSemanticSegModel(d), d, SemanticSegModel(d, device="cpu")


def _outputs(out):
    """The leaves of a forward's output as NHWC / (b, na, ny, nx, no) numpy arrays."""
    if torch.is_tensor(out):
        out = [out]
    leaves = []
    for t in out:
        if isinstance(t, (list, tuple)):
            leaves += _outputs(t)
        else:
            t = t.detach()
            leaves.append((t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy())
    return leaves


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_pt_reads_as_jax_imports_it(case, tmp_path):
    cfg, div, layout, unread = CASES[case]
    jm, d, port = _models(cfg, div)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=7)
    sd = reference_state_dict({k: t for k, t in state_dict_from_flax(v).items()}, port.spec,
                              semantic_roots=not _segment(cfg))
    path, root = tmp_path / f"{case}.pt", None
    if layout == "half_module":
        root = write_reference_tree(tmp_path / "reference")
        save_pickled_module(path, sd, root)
        v = jax.tree_util.tree_map(lambda a: a.astype(np.float16).astype(np.float32), v)
    elif layout == "foreign":
        torch.save({re.sub(r"^(backbone|head)\.", "encoder.", k): t for k, t in sd.items()}, path)
    else:
        torch.save({"model": sd, "epoch": 3}, path)
    template = jax.tree_util.tree_map(np.zeros_like, v)

    if layout == "foreign":
        sd_np = jax_load(path)
        with pytest.raises(ValueError, match="strict torch import failed"):
            jax_import(template, sd_np, spec=jm.spec)
        with pytest.raises(ValueError, match="matched 0"):
            jax_import(template, sd_np, spec=jm.spec, strict=False)
        with pytest.raises(ValueError, match="matched 0"):
            resolve_state_dict(path, port)
        with pytest.raises(ValueError, match="matched 0"):
            import_torch_state_dict(port, torch.load(path, weights_only=True), strict=False)
        return

    # the port first: it needs the stand-in tree on sys.path, which reference_root
    # puts there, as it puts it for JAX
    if root is not None:
        with pytest.raises(ModuleNotFoundError, match="reference_stub"):
            resolve_state_dict(path, port)
        sd_port = load_torch_checkpoint(path, reference_root=root)
        port.load_state_dict(resolve_state_dict(path, port), strict=True)
        assert all(torch.equal(sd_port[k], t) for k, t in load_torch_checkpoint(path).items())
        forget_reference_tree(root)
    else:
        port.load_state_dict(resolve_state_dict(path, port), strict=True)

    sd_np = jax_load(path, reference_root=root)
    if unread is None:
        vj = jax_import(template, sd_np, spec=jm.spec)
    else:
        with pytest.raises(ValueError, match="strict torch import failed"):
            jax_import(template, sd_np, spec=jm.spec)
        vj = jax_import(template, sd_np, spec=jm.spec, strict=False)
    got_leaves, want_leaves = _flat(vj), _flat(v)
    left = [p for p in want_leaves if not np.array_equal(got_leaves[p], want_leaves[p])]
    if unread is None:
        assert not left
    else:
        assert left and all(re.search(unread, ".".join(p)) for p in left)
    vj = _unflat({p: want_leaves[p] if p in left else got_leaves[p] for p in want_leaves})

    x = np.random.default_rng(8).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    if _segment(cfg):
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False, decode=False))(vj, x)
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2), decode=False)
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x))(vj, x)
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    got = _outputs(got)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("key,want", [
    ("backbone.0.stem.0.conv.weight", "model.0.conv.conv.weight"),
    ("backbone.1.layer.2.conv3.bn.running_var", "model.1.layer.2.conv3.bn.running_var"),
    ("head.0.lateral1.conv.weight", "model.4.lateral1.conv.weight"),
    ("backbone.3.block.1.bn.bias", "model.3.conv1.bn.bias"),
    ("model.2.1.cv1.conv.weight", "model.2.1.cv1.conv.weight"),
    ("model.8.m_tr.tr.0.fc1.weight", "model.8.m.tr.0.fc1.weight"),
    ("model.24.m.0.weight", "model.24.m.0.weight"),
    ("model.24.anchors", None),
    ("backbone.0.stem.0.bn.num_batches_tracked", None),
])
def test_translate_torch_key_follows_jax_rules(key, want):
    """One key each of JAX's renames (io/torch_import.py:54-132), under the
    port's names, with n_backbone 4."""
    assert translate_torch_key(key, n_backbone=4) == want


def test_model_less_read_refuses_what_it_cannot_place(tmp_path):
    """Without the model, `backbone.` / `head.` roots have no rows: the
    model-less reads raise rather than put `head.{j}` on row j, as does a
    file where two keys name one entry."""
    from yolo_dual_tpu_torch.io.torch_import import port_state_dict
    from yolo_dual_tpu_torch.io.weights import load_state_dict_file

    d = narrow_semantic("resnet18", 8)
    port = SemanticSegModel(d, device="cpu")
    sd = reference_state_dict(port.state_dict(), port.spec, semantic_roots=True)
    path = tmp_path / "semantic.pt"
    torch.save({"model": sd}, path)
    for read in (load_state_dict_file, resolve_state_dict):
        with pytest.raises(ValueError, match="backbone./head."):
            read(path)
    nb = port.spec.n_backbone
    got = resolve_state_dict(path, port)
    assert all(torch.equal(got[k], t) for k, t in port.state_dict().items())
    head = next(k for k in sd if k.startswith("head.0."))
    clash = {f"model.{nb}." + head.split(".", 2)[2]: sd[head], head: sd[head]}
    with pytest.raises(ValueError, match="both translate to"):
        list(port_state_dict(clash, port.spec))
