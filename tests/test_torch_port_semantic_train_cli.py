"""The port's semantic train CLI (python -m yolo_dual_tpu_torch.semantic.train)
on the CPU against the JAX package's root semantic/train.py: the narrow
ResNet18 of tests/torch_port_common.py, BatchNorm calibrated on the frames,
from the same weights (an orbax checkpoint of JAX's variables for JAX's
--weights, the port's state_dict of them for the port's), a seeded set of 10 frames of 72x96 (PNG for JAX,
`.npy` of the same pixels for the port) with JSON masks, 2 epochs at bs 4,
imgsz 64, --nbs 8 (accumulate 2), augmentation on, on the host route and on
the device route.

Tolerances, measured values in brackets: the training loss columns of
results.csv within 1e-5 relative [host 1.1e-6, device 5.1e-7]; mIoU and
fitness within 1e-4 [host 2.9e-5, device 1.3e-6: the random narrow net's
argmax flips at near ties], the val loss within 1e-5 relative [host 4.7e-7,
device 1.3e-7]. The samples of both routes are exact (the numpy warpAffine
and GaussianBlur equal OpenCV's), so what differs is float32 arithmetic.
Resuming: a run interrupted after epoch 1 and resumed from its last.pt
equals the uninterrupted run exactly (results.csv and every weight).
Validation inside training folds a copy: the live EMA keeps its BatchNorms
and its second epoch's mIoU equals a run that hands the validator a copy
itself (within 1e-6 [0]).
"""

import copy
import importlib.util
import json
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import (ROOT, SEM_NC, calibrated_semantic, narrow_semantic,
                               random_variables, write_json_set)
from yolo_dual_tpu.data.json_dataset import JSONSegmentDataset as JaxJSONDataset
from yolo_dual_tpu.losses.semantic import parse_class_weights as jax_parse_class_weights
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from yolo_dual_tpu_torch.data import json_dataset
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.semantic import train as port_train

cv2 = pytest.importorskip("cv2")
IMGSZ = 64
LOSS_RTOL, MIOU_ATOL, VLOSS_RTOL = 1e-5, 1e-4, 1e-5


def _jax_cli():
    spec = importlib.util.spec_from_file_location("sem_train_vs_port",
                                                  str(ROOT / "semantic" / "train.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_set(tmp_path_factory):
    """The dataset, the narrow config as YAML (JAX) and JSON (the port), the
    calibrated weights as an orbax checkpoint and as a `.pt` state_dict."""
    root = write_json_set(tmp_path_factory.mktemp("sem_train_cli"), 10, (72, 96), seed=17)
    d = narrow_semantic("resnet18", 8)
    (root / "narrow.yaml").write_text(yaml.safe_dump(d))
    (root / "narrow.json").write_text(json.dumps(d))
    jm = JaxSemanticSegModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=12)
    ds = json_dataset.JSONSegmentDataset(root / "port" / "images", root / "json", IMGSZ)
    images = np.stack([ds[i]["image"] for i in range(8)])
    v = calibrated_semantic(jm, v, d, torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255)
    jax_save_checkpoint(root / "jax_weights", {"variables": v})
    torch.save(state_dict_from_flax(v), root / "port_weights.pt")
    return root


def _args(root, project, epochs=2):
    return ["--imgsz", str(IMGSZ), "--batch-size", "4", "--epochs", str(epochs), "--nbs", "8",
            "--seed", "1", "--json-dir", str(root / "json"), "--project", str(project),
            "--name", "exp"]


def _port_args(root, project, epochs=2):
    return _args(root, project, epochs) + [
        "--cfg", str(root / "narrow.json"), "--img-dir", str(root / "port" / "images"),
        "--weights", str(root / "port_weights.pt"), "--device", "cpu"]


def _results(run_dir):
    return np.loadtxt(run_dir / "results.csv", delimiter=",", skiprows=1, ndmin=2)


@pytest.mark.parametrize("route", ["host", "device"])
def test_cli_matches_jax(run_set, tmp_path, route):
    """Every results.csv column of 2 epochs against JAX's, and the run's
    files: last.pt and best.pt (stripped to the EMA), opt.json, hyp.json."""
    extra = ["--device-preprocess"] if route == "device" else []
    jax_train = _jax_cli()
    jax_best = jax_train.train(jax_train.parse_opt(
        _args(run_set, tmp_path / "jax") + extra + [
            "--cfg", str(run_set / "narrow.yaml"), "--img-dir", str(run_set / "jax" / "images"),
            "--weights", str(run_set / "jax_weights")]))
    best = port_train.main(_port_args(run_set, tmp_path / "port") + extra)
    want, got = _results(tmp_path / "jax" / "exp"), _results(tmp_path / "port" / "exp")
    assert got.shape == want.shape == (2, 7)
    header = (tmp_path / "port" / "exp" / "results.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "jax" / "exp" / "results.csv").read_text().splitlines()[0]
    np.testing.assert_array_equal(got[:, 0], [0, 1])
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[:, [4, 6]], want[:, [4, 6]], rtol=0, atol=MIOU_ATOL)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=VLOSS_RTOL)
    assert best == pytest.approx(jax_best, abs=MIOU_ATOL)
    run = tmp_path / "port" / "exp"
    last, best_ckpt = (port_train.load_checkpoint(run / f) for f in ("last.pt", "best.pt"))
    assert last["epoch"] == 1 and last["optimizer"]["count"] == 2 and last["updates"] == 2
    assert best_ckpt["optimizer"] is None and best_ckpt["epoch"] == -1
    assert set(best_ckpt["model"]) == set(last["ema"])
    assert json.loads((run / "opt.json").read_text())["device_preprocess"] == (route == "device")
    assert json.loads((run / "hyp.json").read_text()) == yaml.safe_load(
        (ROOT / "yolo_dual_tpu" / "configs" / "hyps" / "hyp.scratch-seg.yaml").read_text())


@pytest.fixture
def one_thread():
    """torch on one CPU thread: some CPU kernels accumulate in an order that
    depends on how the machine schedules their threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_continues_exactly(run_set, tmp_path, one_thread):
    """A device-route run interrupted after epoch 1, resumed with a bare
    --resume, against the uninterrupted 3-epoch run; then the run's opt.json
    supplies the settings, a typed --epochs wins, results.csv grows."""
    args = ["--device-preprocess"]
    port_train.main(_port_args(run_set, tmp_path / "a", epochs=3) + args)

    class Interrupt(Exception):
        pass
    save = port_train.save_checkpoint

    def save_then_stop(path, ckpt):
        save(path, ckpt)
        if ckpt["epoch"] == 1 and path.name == "last.pt":
            raise Interrupt
    port_train.save_checkpoint = save_then_stop
    try:
        with pytest.raises(Interrupt):
            port_train.main(_port_args(run_set, tmp_path / "b", epochs=3) + args)
    finally:
        port_train.save_checkpoint = save
    opt = port_train.parse_opt(["--project", str(tmp_path / "b"), "--name", "exp", "--resume",
                                "--device", "cpu"])
    port_train.train(opt)
    assert opt.epochs == 3 and opt.imgsz == IMGSZ and opt.device_preprocess
    a, b = tmp_path / "a" / "exp", tmp_path / "b" / "exp"
    assert (b / "results.csv").read_text() == (a / "results.csv").read_text()
    la, lb = (port_train.load_checkpoint(d / "last.pt") for d in (a, b))
    for key in ("model", "ema"):
        assert all(torch.equal(la[key][k], lb[key][k]) for k in la[key]), key
    assert la["optimizer"]["count"] == lb["optimizer"]["count"] and la["updates"] == lb["updates"]
    port_train.main(["--project", str(tmp_path / "b"), "--name", "exp", "--epochs", "4",
                     "--resume", "--device", "cpu"])
    assert not (tmp_path / "b" / "exp2").exists(), "bare --resume created a new run dir"
    np.testing.assert_array_equal(_results(b)[:, 0], [0, 1, 2, 3])


def test_validation_folds_a_copy_of_the_live_ema(run_set, tmp_path, monkeypatch):
    """evaluate_semantic folds conv+BN into the model it is given: the CLI
    hands it a copy, so after 2 epochs the live EMA still has every
    BatchNorm, and epoch 2's mIoU equals a run whose validator is handed a
    copy by the test itself."""
    emas = []

    class Recorded(port_train.ModelEMA):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            emas.append(self)
    monkeypatch.setattr(port_train, "ModelEMA", Recorded)
    port_train.main(_port_args(run_set, tmp_path / "a"))
    evaluate = port_train.evaluate_semantic
    monkeypatch.setattr(port_train, "evaluate_semantic",
                        lambda model, *a, **k: evaluate(copy.deepcopy(model), *a, **k))
    port_train.main(_port_args(run_set, tmp_path / "b"))
    ema = emas[0].ema
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in ema.modules())
    assert n_bn > 15 and n_bn == sum(isinstance(m, torch.nn.BatchNorm2d)
                                     for m in emas[1].ema.modules())
    assert emas[0].updates == 2 and set(emas[0].ema.state_dict()) == set(
        port_train.load_checkpoint(tmp_path / "a" / "exp" / "last.pt")["model"])
    got, want = _results(tmp_path / "a" / "exp"), _results(tmp_path / "b" / "exp")
    np.testing.assert_allclose(got[1, 4], want[1, 4], rtol=0, atol=1e-6)


def test_class_weights_and_mask_dir(run_set, tmp_path, monkeypatch):
    """--class-weights from a YAML {name: weight} file and from a CSV
    string, and --auto-weights, reach the loss as JAX computes them; with
    --mask-dir the missing JSON records are written from PNG masks first."""
    seen = []
    loss_cls = port_train.SemanticSegLoss

    def spy(*a, **k):
        seen.append(k.get("class_weights"))
        return loss_cls(*a, **k)
    monkeypatch.setattr(port_train, "SemanticSegLoss", spy)
    names = port_train.CLASS_NAMES
    weights = {n: round(0.5 + 0.1 * i, 2) for i, n in enumerate(reversed(names))}
    (tmp_path / "weights.yaml").write_text(yaml.safe_dump(weights))
    csv = ",".join(str(1.0 + i / 10) for i in range(SEM_NC))
    masks = tmp_path / "masks"
    masks.mkdir()
    for f in sorted((run_set / "json").glob("*.json")):
        m = np.asarray(json.loads(f.read_text())["mask_data"], np.uint8).reshape(72, 96)
        cv2.imwrite(str(masks / f"{f.stem}.png"), m)
    json_dir = tmp_path / "json"
    for flags in (["--class-weights", str(tmp_path / "weights.yaml")], ["--class-weights", csv],
                  ["--auto-weights", "--mask-dir", str(masks)]):
        args = _port_args(run_set, tmp_path / "runs", epochs=1) + flags
        if "--mask-dir" in flags:
            args[args.index("--json-dir") + 1] = str(json_dir)
        port_train.main(args)
    want = [jax_parse_class_weights(str(tmp_path / "weights.yaml"), SEM_NC, names),
            jax_parse_class_weights(csv, SEM_NC, names),
            JaxJSONDataset(run_set / "jax" / "images", run_set / "json").class_weights()]
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, w)
    assert [f.name for f in sorted(json_dir.glob("*.json"))] == \
        [f.name for f in sorted((run_set / "json").glob("*.json"))]


def test_cli_refuses_what_is_not_ported(run_set, tmp_path):
    # --data-parallel runs: in one process (no torch.distributed.run) as without it
    port_train.main(_port_args(run_set, tmp_path / "plain", epochs=1))
    port_train.main(_port_args(run_set, tmp_path / "dp", epochs=1) + ["--data-parallel"])
    plain, dp = (np.loadtxt(next((tmp_path / d).rglob("results.csv")), delimiter=",", skiprows=1)
                 for d in ("plain", "dp"))
    np.testing.assert_array_equal(dp, plain)
    assert list((tmp_path / "dp").rglob("events.out.tfevents.*"))  # the TB scalars and panels
    jax_opt = vars(_jax_cli().parse_opt([]))
    port_opt = vars(port_train.parse_opt([]))
    assert set(jax_opt) == set(port_opt)
    differ = {k for k in jax_opt if jax_opt[k] != port_opt[k]}
    assert differ == {"device"}, differ  # the port defaults to cuda
    assert port_train.parse_opt(["--no-fused-bn"]).fused_bn is False
