"""Package rules of the PyTorch port: its JSON config copies equal the JAX
yamls, and neither the package nor chip_smoke.py imports JAX or the JAX
package."""

import ast
import json

import pytest
import yaml

from torch_port_common import ROOT, SEG_CFG

PORT = ROOT / "yolo_dual_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yolo_dual_tpu"}


@pytest.mark.parametrize("size", "nsmlx")
def test_json_config_equals_yaml(size):
    name = f"yolov5{size}-seg"
    port = json.loads((PORT / "configs" / "segment" / f"{name}.json").read_text())
    assert port == yaml.safe_load((SEG_CFG / f"{name}.yaml").read_text())


def test_dcnv3_json_is_yolov5s_seg_with_rows_4_6_8_renamed():
    """yolov5s-seg-dcnv3.json is yolov5s-seg.yaml with exactly backbone rows 4,
    6 and 8 changed from C3 to C3_DCNV3."""
    port = json.loads((PORT / "configs" / "segment" / "yolov5s-seg-dcnv3.json").read_text())
    ref = yaml.safe_load((SEG_CFG / "yolov5s-seg.yaml").read_text())
    assert [i for i, (p, r) in enumerate(zip(port["backbone"], ref["backbone"])) if p != r] == [4, 6, 8]
    for i in (4, 6, 8):
        assert ref["backbone"][i][2] == "C3"
        ref["backbone"][i][2] = "C3_DCNV3"
    assert port == ref


def _imported_top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {PORT / "nn" / "dcn.py", PORT / "kernels" / "dcn_sampling.py", PORT / "nn" / "spp.py",
            PORT / "nn" / "attention.py", PORT / "engine" / "autoshape.py"} <= set(files)
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_top_levels(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}
