"""The port's classify CLIs against the JAX package's root classify/ scripts on
the CPU, on the colour set of tests/test_classify.py (3 classes of 48 px
frames, 24 a class to train and 8 to validate; PNG for JAX, `.npy` copies of
the same RGB pixels for the port) and its two-Conv config (relu, as the
semantic dialect of a config without anchors gives it).

- classify.train against JAX's train.py over 3 epochs at bs 8, 32 px, seed 0,
  augmentation on, --dropout 0, both from JAX's initial weights under
  PRNGKey(0): each epoch's train loss within 1e-3 relative, top-1 and top-5
  equal;
- the port's learning proof, JAX's recipe (25 epochs, bs 16, lr0 0.01): best
  top-1 > 0.9;
- classify.val and classify.predict on that run's last.pt against JAX's
  val.py and predict.py on the same weights (an orbax checkpoint of
  torch_port_common.flax_from_state_dict): top-1 and top-5 equal, the top-k
  classes equal, probabilities within 1e-5, the --save-txt rows the same.
"""

import csv
import importlib.util
import json
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import ROOT, flax_from_state_dict
from yolo_dual_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from yolo_dual_tpu_torch.classify import predict as predict_cli
from yolo_dual_tpu_torch.classify import train as train_cli
from yolo_dual_tpu_torch.classify import val as val_cli
from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint

cv2 = pytest.importorskip("cv2")
COLORS = {"red": (220, 30, 30), "green": (30, 220, 30), "blue": (30, 30, 220)}
MINI = dict(nc=3, depth_multiple=1.0, width_multiple=1.0,
            backbone=[[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]], head=[])


def jax_script(name):
    """JAX's root classify/<name>.py as a module of its own name."""
    key = f"jax_classify_{name}"
    if key not in sys.modules:
        sys.path.insert(0, str(ROOT / "classify"))  # val.py and predict.py import `train`
        spec = importlib.util.spec_from_file_location(key, ROOT / "classify" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def make_imageset(root, n_per_class=24, size=48, seed=0):
    """tests/test_classify.py:_make_imageset, into root/jax as PNG and
    root/port as `.npy`."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_per_class), ("val", max(n_per_class // 3, 4))):
        for cname, rgb in COLORS.items():
            for side in ("jax", "port"):
                (root / side / split / cname).mkdir(parents=True, exist_ok=True)
            for i in range(n):
                im = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
                x0, y0 = rng.integers(0, size // 4, 2)
                im[y0:y0 + size // 2 + 8, x0:x0 + size // 2 + 8] = rgb
                cv2.imwrite(str(root / "jax" / split / cname / f"{i}.png"), im[..., ::-1])
                np.save(root / "port" / split / cname / f"{i}.npy", im)
    (root / "mini.yaml").write_text(yaml.safe_dump(MINI))
    (root / "mini.json").write_text(json.dumps(MINI))
    return root


def results(run):
    with open(run / "results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "train_loss", "top1", "top5"]
    return np.array(rows[1:], np.float64)


@pytest.fixture(scope="module")
def imageset(tmp_path_factory):
    return make_imageset(tmp_path_factory.mktemp("cls"))


def test_train_cli_matches_jax(imageset, tmp_path):
    root = imageset
    args = ["--cutoff", "2", "--epochs", "3", "--batch-size", "8", "--imgsz", "32",
            "--lr0", "0.01", "--seed", "0", "--dropout", "0", "--project", str(tmp_path)]
    jct = jax_script("train")
    jct.train(jct.parse_opt(["--model", str(root / "mini.yaml"), "--data-dir", str(root / "jax"),
                             "--name", "jax"] + args))
    train_cli.main(["--model", str(root / "mini.json"), "--data-dir", str(root / "port"),
                    "--name", "port", "--device", "cpu"] + args)
    want, got = results(tmp_path / "jax"), results(tmp_path / "port")
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-3)
    np.testing.assert_array_equal(got[:, [0, 2, 3]], want[:, [0, 2, 3]])
    ckpt = load_checkpoint(tmp_path / "port" / "last.pt")
    assert ckpt["epoch"] == 2 and ckpt["classes"] == ["blue", "green", "red"]
    assert ckpt["ema"].keys() == ckpt["model"].keys()


@pytest.fixture(scope="module")
def proof(imageset, tmp_path_factory):
    """The port's run of JAX's learning recipe: (best top-1, run directory)."""
    project = tmp_path_factory.mktemp("cls_runs")
    best = train_cli.main(["--model", str(imageset / "mini.json"), "--data-dir",
                           str(imageset / "port"), "--cutoff", "2", "--epochs", "25",
                           "--batch-size", "16", "--imgsz", "32", "--lr0", "0.01", "--seed", "0",
                           "--project", str(project), "--name", "proof", "--device", "cpu"])
    return best, project / "proof"


def test_learning_proof(proof):
    best, run = proof
    assert best > 0.9, f"top1 {best} <= 0.9 on a trivially separable set"
    assert results(run)[:, 2].max() == best and (run / "best.pt").exists()


def test_val_and_predict_match_jax(imageset, proof, tmp_path):
    root, (_, run) = imageset, proof
    jm = jax_script("train").build_classifier(str(root / "mini.yaml"), 3, cutoff=2)
    template = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False),
                              jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 32, 32, 3),
                                                                          jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    ema = load_checkpoint(run / "last.pt")["ema"]
    jax_save_checkpoint(tmp_path / "jax_weights", {
        "variables": flax_from_state_dict(template, ema), "classes": ["blue", "green", "red"]})
    common = dict(imgsz=32, cutoff=2, batch_size=8)

    want = jax_script("val").run(weights=str(tmp_path / "jax_weights"),
                                 model=str(root / "mini.yaml"), data_dir=str(root / "jax"), **common)
    got = val_cli.run(weights=str(run / "last.pt"), model=str(root / "mini.json"),
                      data_dir=str(root / "port"), device="cpu", verbose=True, **common)
    assert got == tuple(float(w) for w in want) and got[0] > 0.9
    assert val_cli.run.logits.shape == (24, 3)
    csv_top1 = results(run)[-1, 2]
    assert got[0] == csv_top1  # val on last.pt reads what the run's last epoch wrote

    pkw = dict(imgsz=32, cutoff=2, topk=3, save_txt=True, exist_ok=True)
    want = jax_script("predict").run(weights=str(tmp_path / "jax_weights"),
                                     model=str(root / "mini.yaml"),
                                     source=str(root / "jax" / "val" / "red"),
                                     project=str(tmp_path), name="jax", **pkw)
    got = predict_cli.run(weights=str(run / "last.pt"), model=str(root / "mini.json"),
                          source=str(root / "port" / "val" / "red"), project=str(tmp_path),
                          name="port", device="cpu", **pkw)
    assert len(got) == len(want) == 8
    for (gp, go, gprob), (wp, wo, wprob) in zip(got, want):
        assert gp.rsplit("/", 1)[-1].split(".")[0] == wp.rsplit("/", 1)[-1].split(".")[0]
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_allclose(gprob, wprob, atol=1e-5)
    for i in range(8):
        assert (tmp_path / "port" / "labels" / f"{i}.txt").read_text() \
            == (tmp_path / "jax" / "labels" / f"{i}.txt").read_text()
        assert (tmp_path / "port" / f"{i}.jpg").exists()
    stripped = tmp_path / "stripped.pt"  # --update: the EMA weights stay, as `model`
    stripped.write_bytes((run / "last.pt").read_bytes())
    again = predict_cli.run(weights=str(stripped), model=str(root / "mini.json"), update=True,
                            source=str(root / "port" / "val" / "red"), project=str(tmp_path),
                            name="stripped", device="cpu", nosave=True, imgsz=32, cutoff=2, topk=3)
    assert load_checkpoint(stripped)["ema"] is None
    for (_, go, gprob), (_, ao, aprob) in zip(got, again):
        np.testing.assert_array_equal(go, ao)
        np.testing.assert_array_equal(gprob, aprob)
    with pytest.raises(FileNotFoundError, match="clip.mp4"):   # video sources are read now
        predict_cli.run(model=str(root / "mini.json"), source=str(tmp_path / "clip.mp4"),
                        cutoff=2, device="cpu", nosave=True)
    # --plots draws JAX's val_images.jpg mosaic, pixel for pixel
    jax_script("val").run(weights=str(tmp_path / "jax_weights"), model=str(root / "mini.yaml"),
                          data_dir=str(root / "jax"), plots=True, save_dir=str(tmp_path / "jp"),
                          **common)
    val_cli.run(weights=str(run / "last.pt"), model=str(root / "mini.json"), plots=True,
                data_dir=str(root / "port"), device="cpu", save_dir=str(tmp_path / "pp"), **common)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "pp" / "val_images.jpg")),
                                  cv2.imread(str(tmp_path / "jp" / "val_images.jpg")))
    # --data-parallel runs; in one process (no torch.distributed.run) as without the flag
    top1 = train_cli.main(["--model", str(root / "mini.json"), "--data-dir", str(root / "port"),
                           "--data-parallel", "--device", "cpu", "--epochs", "1", "--imgsz", "32",
                           "--cutoff", "2", "--batch-size", "8", "--project", str(tmp_path),
                           "--name", "dp"])
    assert 0.0 <= top1 <= 1.0 and len(results(tmp_path / "dp")) == 1
    if not torch.cuda.is_available():
        for call in (lambda: val_cli.main(["--data-dir", str(root / "port")]),
                     lambda: predict_cli.main(["--source", str(root / "port")]),
                     lambda: train_cli.main(["--data-dir", str(root / "port")])):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                call()
