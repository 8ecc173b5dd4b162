"""The port's JSON copies of the JAX package's detect configs (models/, hub/
but anchors.yaml, spp/, attention/ and backbone/: 48 configs, the 11
torchvision-backbone ones among them), each built at full width: the copy
equals JAX's yaml, the port's meta build
has JAX's name -> shape map (JAX's tree from jax.eval_shape of model.init at
128 px, no FLOPs, mapped through state_dict_from_flax) and loads such a tree
with strict=True, and the parameter counts and head strides are JAX's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import ROOT
from yolo_dual_tpu.models.compiler import parse_config as jax_parse_config
from yolo_dual_tpu.models.model import GraphModel as JaxGraphModel
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.compiler import parse_config
from yolo_dual_tpu_torch.models.model import GraphModel, _probe_strides, build_model
from yolo_dual_tpu_torch.utils.general import CONFIG_DIRS, find_cfg

JAX_CFG = ROOT / "yolo_dual_tpu" / "configs"
PORT_CFG = ROOT / "yolo_dual_tpu_torch" / "configs"
ZOO = sorted([f"models/{p.stem}" for p in JAX_CFG.glob("models/*.yaml")]
             + [f"hub/{p.stem}" for p in JAX_CFG.glob("hub/*.yaml") if p.stem != "anchors"]
             + [f"spp/{p.stem}" for p in JAX_CFG.glob("spp/*.yaml")]
             + [f"attention/{p.stem}" for p in JAX_CFG.glob("attention/*.yaml")]
             + [f"backbone/{p.stem}" for p in JAX_CFG.glob("backbone/*.yaml")])
# the stems that two copies share: a bare stem finds the first folder in CONFIG_DIRS
SHARED_STEMS = {"resnet18", "resnet50"}


def test_zoo_has_37_configs_and_find_cfg_finds_each_by_its_stem():
    """The 37 configs of the zoo before the torchvision backbones are found by
    their bare stems; with the 11 backbone configs the zoo holds 48. Every
    copy is found by its folder-qualified name (`backbone/resnet18.yaml`), and
    the only stems two copies share are SHARED_STEMS (semantic/ and
    backbone/), which bare resolve to the first of their folders in
    CONFIG_DIRS: semantic/, so `resnet50.yaml` stays the semantic flagship."""
    assert len(ZOO) == 48
    earlier = [n for n in ZOO if not n.startswith("backbone/") or n == "backbone/yolov5n-DCN"]
    assert len(earlier) == 37
    for name in earlier:
        assert find_cfg(name.split("/")[1] + ".yaml") == PORT_CFG / f"{name}.json"
    copies = sorted(p for sub in CONFIG_DIRS for p in (PORT_CFG / sub).glob("*.json"))
    for p in copies:
        folder = p.parent.name
        assert find_cfg(f"{folder}/{p.stem}.yaml") == find_cfg(f"{folder}/{p.stem}.json") == p
    by_stem = {}
    for p in copies:
        by_stem.setdefault(p.stem, []).append(p)
    shared = {stem: ps for stem, ps in by_stem.items() if len(ps) > 1}
    assert set(shared) == SHARED_STEMS
    for stem, ps in shared.items():
        first = min(ps, key=lambda p: CONFIG_DIRS.index(p.parent.name))
        assert first.parent.name == "semantic" and find_cfg(f"{stem}.yaml") == first


@pytest.mark.parametrize("name", ZOO)
def test_json_config_equals_yaml(name):
    port = json.loads((PORT_CFG / f"{name}.json").read_text())
    assert port == yaml.safe_load((JAX_CFG / f"{name}.yaml").read_text())


@pytest.mark.parametrize("name", ZOO)
def test_full_width_graph_matches_jax_tree(name):
    """JAX's name -> shape map, a strict load of a JAX tree, JAX's parameter
    count and JAX's strides: one jax.eval_shape of init_with_output of JAX's
    graph at 128 px gives the tree and the raw head maps."""
    d = yaml.safe_load((JAX_CFG / f"{name}.yaml").read_text())
    jg = JaxGraphModel(jax_parse_config(d))
    levels, shapes = jax.eval_shape(
        lambda k, x: jg.init_with_output(k, x, train=False, decode=False), jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = state_dict_from_flax(zeros)
    spec = _probe_strides(parse_config(d))
    with torch.device("meta"):
        model = GraphModel(spec)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == {k: tuple(v.shape) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert spec.strides == tuple(128 // lvl.shape[2] for lvl in levels) \
        and model.model[-1].strides == spec.strides


def test_build_model_picks_the_task_as_jax_does():
    for cfg in ("models/yolov5n", "segment/yolov5n-seg", "semantic/resnet18"):
        d = yaml.safe_load((JAX_CFG / f"{cfg}.yaml").read_text())
        assert type(build_model(d, device="cpu")).__name__ == type(jax_build_model(d)).__name__
    for cfg in ("backbone/resnet18", "backbone/vgg11_bn"):
        d = yaml.safe_load((JAX_CFG / f"{cfg}.yaml").read_text())
        assert type(build_model(d, device="cpu")).__name__ == type(jax_build_model(d)).__name__
    assert type(build_model("yolov5n.json", task="classify", device="cpu")).__name__ \
        == "ClassificationModel"
    aux = yaml.safe_load((JAX_CFG / "loss" / "yolov5n_auxota.yaml").read_text())
    assert type(build_model(aux, device="cpu")).__name__ == type(jax_build_model(aux)).__name__ \
        == "DetectionModel"
    d = yaml.safe_load((JAX_CFG / "models" / "yolov5n.yaml").read_text())
    d["backbone"][1][2] = "Fokus"  # a name in neither registry
    with pytest.raises(KeyError, match="not ported"):
        parse_config(d)
