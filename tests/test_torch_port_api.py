"""The port's public surface against the JAX package's: the names each JAX
subpackage exports, register_module before the first build, the dataset
tools (data/tools.py), the utils helpers and the model-zoo smoke CLI.

JAX's two TPU dispatch names have no literal counterpart in the port; they
map (TPU_ONLY) to the port's CUDA dispatch, `dcnv3_sampling`, which launches
csrc/dcnv3.cu (K2) on CUDA tensors and runs the plain `dcnv3_core` on CPU
tensors: `use_pallas` is JAX's choice between its Pallas kernel and the lax
core, and `dcnv3_core_pallas` that kernel.
"""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from yolo_dual_tpu.data import tools as jax_tools
from yolo_dual_tpu.utils import general as jax_general
from yolo_dual_tpu_torch import zoo_smoke
from yolo_dual_tpu_torch.data import tools
from yolo_dual_tpu_torch.utils import general

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "yolo_dual_tpu"
PACKAGES = ("data", "engine", "io", "kernels", "losses", "models", "nn", "ops", "train", "utils")
TPU_ONLY = {"use_pallas": "dcnv3_sampling", "dcnv3_core_pallas": "dcnv3_sampling"}


def jax_exports(pkg: str) -> list:
    """The names JAX's `yolo_dual_tpu/{pkg}/__init__.py` imports."""
    tree = ast.parse((JAX_PKG / pkg / "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_export_imports_from_the_port(pkg):
    port = importlib.import_module(f"yolo_dual_tpu_torch.{pkg}")
    names = jax_exports(pkg)
    assert names
    for name in names:
        obj = getattr(port, TPU_ONLY.get(name, name))
        assert obj is not None, name
        assert TPU_ONLY.get(name, name) in port.__all__
    if pkg == "kernels":
        assert set(TPU_ONLY) <= set(names)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)


def test_importing_the_subpackages_imports_no_module_and_builds_nothing():
    """`import yolo_dual_tpu_torch` and its ten subpackages load no module of
    theirs (so no kernel is built and io/ocdbt.py's ctypes load does not
    happen); a name then loads the module that defines it."""
    code = f"""
import sys
import yolo_dual_tpu_torch
for p in {PACKAGES!r}:
    __import__("yolo_dual_tpu_torch." + p)
mods = sorted(m for m in sys.modules if m.startswith("yolo_dual_tpu_torch."))
assert mods == sorted(["yolo_dual_tpu_torch._lazy"] + ["yolo_dual_tpu_torch." + p for p in {PACKAGES!r}]), mods
from yolo_dual_tpu_torch.engine import evaluate_segment
from yolo_dual_tpu_torch.kernels import dcnv3_sampling, letterbox_normalize
assert "yolo_dual_tpu_torch.engine.validator" in sys.modules
assert dcnv3_sampling.launches == 0 and letterbox_normalize.launches == 0
from yolo_dual_tpu_torch.kernels import build
assert not build._LIBS, build._LIBS
assert not any(m.startswith(("jax", "yolo_dual_tpu.")) or m == "yolo_dual_tpu" for m in sys.modules)
print("ok")
"""
    r = _python(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_register_module_before_the_first_build_keeps_the_builtins():
    """A name registered in a fresh interpreter before any model is built
    compiles (its args pass c2-first, as in JAX's default branch), builds,
    and the 93 built-in names stay registered beside it."""
    code = """
import torch
from yolo_dual_tpu_torch.models import compiler, register_module
assert not compiler.REGISTRY


class Twice(torch.nn.Module):
    def __init__(self, c1, c2=None):
        super().__init__()
        self.c2 = c2

    def forward(self, x):
        return 2 * x


register_module("Twice", lambda c1, kw: Twice(c1, **kw))
from yolo_dual_tpu_torch.models import build_model
d = dict(nc=3, backbone=[[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Twice", [8]],
                         [-1, 1, "Conv", [16, 3, 2]]],
         head=[[[1, 2], 1, "SegmentHead", [3, 8]]])
m = build_model(d, device="cpu")
assert isinstance(m.model[1], Twice) and m.model[1].c2 == 8
assert m(torch.zeros(1, 3, 32, 32)).shape == (1, 3, 32, 32)
print(len(compiler.REGISTRY))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) == 93 + 1


# ---------------------------------------------------------------------------
# dataset tools
# ---------------------------------------------------------------------------

SHAPES = ((48, 64), (96, 128), (90, 120), (40, 30))


def write_box_set(root: Path, n: int = 10, seed: int = 3):
    """n seeded smooth frames under root/{jax,port}/data/images, PNG for JAX and
    `.npy` of the same RGB pixels for the port, with the same box labels
    (class xc yc w h, 1-3 a frame, 4 classes) under data/labels; frame 2 has
    no label file, frame 5 an empty one, and frame 7 sits in a subfolder."""
    import cv2
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = SHAPES[i % len(SHAPES)]
        im = cv2.resize(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8), (w, h),
                        interpolation=cv2.INTER_LINEAR)  # smooth, so JPEG keeps it close
        rows = [[rng.integers(0, 4), *rng.uniform(0.25, 0.75, 2), *rng.uniform(0.1, 0.5, 2)]
                for _ in range(0 if i == 5 else rng.integers(1, 4))]
        sub = "deep/" if i == 7 else ""
        for side, suffix in (("jax", "png"), ("port", "npy")):
            img = root / side / "data" / "images" / f"{sub}im{i}.{suffix}"
            img.parent.mkdir(parents=True, exist_ok=True)
            if suffix == "png":
                cv2.imwrite(str(img), im[..., ::-1])
            else:
                np.save(img, im)
            if i != 2:
                lb = root / side / "data" / "labels" / f"{sub}im{i}.txt"
                lb.parent.mkdir(parents=True, exist_ok=True)
                lb.write_text("\n".join(f"{int(r[0])} " + " ".join(f"{v:.6f}" for v in r[1:])
                                        for r in rows))
    return root


@pytest.fixture(scope="module")
def box_sets(tmp_path_factory):
    return write_box_set(tmp_path_factory.mktemp("boxes"))


def _files(d: Path) -> dict:
    return {str(f.relative_to(d)): f for f in sorted(d.rglob("*")) if f.is_file()}


def test_flatten_recursive_matches_jax(box_sets):
    want = _files(jax_tools.flatten_recursive(box_sets / "jax" / "data"))
    got = _files(tools.flatten_recursive(box_sets / "port" / "data"))
    assert sorted(k.replace(".npy", ".png") for k in got) == sorted(want)
    for name, f in got.items():
        if name.endswith(".txt"):
            assert f.read_text() == want[name].read_text()
        else:
            src = next((box_sets / "port" / "data" / "images").rglob(name))
            assert np.array_equal(np.load(f), np.load(src))


@pytest.mark.parametrize("annotated_only", [False, True])
def test_autosplit_matches_jax(box_sets, annotated_only):
    kw = dict(weights=(0.5, 0.3, 0.2), annotated_only=annotated_only, seed=4)
    want = jax_tools.autosplit(box_sets / "jax" / "data" / "images", **kw)
    got = tools.autosplit(box_sets / "port" / "data" / "images", **kw)
    assert [p.name for p in got] == [p.name for p in want]
    lines = [p.read_text().replace(".npy", ".png") if p.exists() else None for p in got]
    assert lines == [p.read_text() if p.exists() else None for p in want]
    assert sum(len(t.splitlines()) for t in lines if t) == (9 if annotated_only else 10)


def test_dataset_stats_match_jax(box_sets):
    want = jax_tools.dataset_stats(box_sets / "jax" / "data" / "images", imgsz=64)
    got = tools.dataset_stats(box_sets / "port" / "data" / "images", imgsz=64)
    assert got == want and got["images"] == 10 and got["instances"] > 9


def test_extract_boxes_matches_jax(box_sets):
    """The same crops under the same names; JAX writes JPEG (lossy), the port
    the crop's exact pixels as `.npy`, within JPEG's error of JAX's file."""
    import cv2
    want = _files(jax_tools.extract_boxes(box_sets / "jax" / "data"))
    got = _files(tools.extract_boxes(box_sets / "port" / "data"))
    assert sorted(k.replace(".npy", ".jpg") for k in got) == sorted(want) and len(got) > 9
    for name, f in got.items():
        crop, jpeg = np.load(f), cv2.imread(str(want[name.replace(".npy", ".jpg")]))[..., ::-1]
        assert crop.shape == jpeg.shape
        assert np.abs(crop.astype(np.float32) - jpeg).mean() < 4  # quality 95, chroma halved


def test_classify_albumentations_is_none_without_the_package():
    from yolo_dual_tpu.data.classify import classify_albumentations as jax_albumentations
    from yolo_dual_tpu_torch.data.classify import classify_albumentations
    assert importlib.util.find_spec("albumentations") is None
    assert classify_albumentations() is None and jax_albumentations() is None


# ---------------------------------------------------------------------------
# utils helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [("hello",), ("red", "x"), ("bright_green", "bold", "underline",
                                                              "results saved to runs/exp")])
def test_colorstr_equals_jax(args):
    assert general.colorstr(*args) == jax_general.colorstr(*args)


@pytest.mark.parametrize("s", ["rtsp://user:pw@host:554/a?b=c", "plain", "a|b#c(1)+¿x¨´<>"])
def test_clean_str_equals_jax(s):
    assert general.clean_str(s) == jax_general.clean_str(s)


def test_yaml_round_trips_jax_files(tmp_path):
    data = {"lr0": 0.01, "names": ["a", "b"], "path": tmp_path / "x", "nested": {"k": [1, 2]},
            "flag": True}
    jax_general.yaml_save(tmp_path / "jax.yaml", data)
    general.yaml_save(tmp_path / "port.yaml", data)
    assert (tmp_path / "jax.yaml").read_text() == (tmp_path / "port.yaml").read_text()
    assert general.yaml_load(tmp_path / "jax.yaml") == jax_general.yaml_load(tmp_path / "port.yaml")
    assert general.yaml_load(tmp_path / "jax.yaml")["path"] == str(tmp_path / "x")
    hyp = ROOT / "yolo_dual_tpu" / "configs" / "hyps" / "hyp.scratch-low.yaml"
    assert general.yaml_load(hyp) == jax_general.yaml_load(hyp) == json.loads(
        (ROOT / "yolo_dual_tpu_torch" / "configs" / "hyps" / "hyp.scratch-low.json").read_text())


def test_platform_info_names_torch():
    import torch
    assert f"torch {torch.__version__}" in general.platform_info()


# ---------------------------------------------------------------------------
# the model-zoo smoke CLI
# ---------------------------------------------------------------------------


def jax_zoo_configs(glob: str) -> list:
    """The configs JAX's tools/zoo_smoke.py builds for `glob`, by its own rule."""
    spec = importlib.util.spec_from_file_location("jax_zoo_smoke", ROOT / "tools" / "zoo_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted(str(p.relative_to(mod.CONFIGS).with_suffix(""))
                  for p in mod.CONFIGS.glob(glob) if p.suffix == ".yaml"
                  and p.parent.name not in ("hyps", "data"))


def test_zoo_smoke_builds_the_segment_configs(capsys):
    """`zoo_smoke --glob 'segment/*'` at 64 px (the shape probe on the meta
    device) exits 0 and lists JAX's segment configs and the port's DCNv3
    model, segment/yolov5s-seg-dcnv3.json, which JAX's configs lack; JAX's
    glob spelling `segment/*.yaml` finds the same files; --profile runs a
    real forward on the CPU."""
    assert zoo_smoke.main("segment/*", 64) == 0
    out = capsys.readouterr().out
    listed = sorted(line.split()[1].removesuffix(".json") for line in out.splitlines()
                    if line.startswith("OK "))
    assert listed == sorted(jax_zoo_configs("segment/*") + ["segment/yolov5s-seg-dcnv3"])
    assert "6/6 configs OK" in out
    assert zoo_smoke.zoo_configs("segment/*.yaml") == zoo_smoke.zoo_configs("segment/*")
    assert zoo_smoke.main("segment/yolov5n-seg.yaml", 64, profile=True, device="cpu") == 0
    assert "fwd" in capsys.readouterr().out
