"""Package rules of the PyTorch port: its JSON config copies equal the JAX
yamls, and neither the package nor chip_smoke.py imports JAX or the JAX
package."""

import ast
import json
import subprocess
import sys

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
            PORT / "nn" / "attention.py", PORT / "engine" / "autoshape.py", PORT / "io" / "ocdbt.py",
            PORT / "io" / "multibackend.py", PORT / "io" / "ensemble.py",
            PORT / "io" / "onnx_export.py", PORT / "export.py", PORT / "hpo.py",
            PORT / "parallel" / "__init__.py", PORT / "parallel" / "mesh.py",
            *(PORT / "utils" / f"{m}.py" for m in (
                "loggers", "remote_loggers", "callbacks", "evolve", "hpo", "autoanchor",
                "autobatch", "profiling", "prune", "plots"))} <= set(files)
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_top_levels(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_weights_modules_load_without_jax_orbax_or_tensorstore():
    """The orbax reader, MultiBackend, Ensemble and export import none of
    jax, flax, orbax, tensorstore or the JAX package, in a fresh interpreter
    (the card's machine has none of them)."""
    code = ("import sys, yolo_dual_tpu_torch.io.ocdbt, yolo_dual_tpu_torch.io.multibackend, "
            "yolo_dual_tpu_torch.io.ensemble, yolo_dual_tpu_torch.export; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'flax', 'orbax', 'tensorstore', 'yolo_dual_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
