"""The port's train CLI (python -m yolo_dual_tpu_torch.segment.train) on the
CPU against the JAX package's segment/train.py, driven as
tests/test_train_cli.py drives it: the primed TINY_SEG of
tests/torch_port_common.py from the same weights (JAX's
export_torch_state_dict into both CLIs' --weights), a dataset written here
(PNG frames for JAX, `.npy` of the same pixels for the port) of frames
that load_image shrinks and enlarges, 2 epochs at bs 4, imgsz 64,
accumulate 2 (--nbs 8).

Tolerances: float32, every loss column within 4e-3 of JAX's, relative (PR
3's train-step tolerance; measured 1.2e-6); the val metrics within 1e-3
(measured 0). bfloat16 (--dtype bf16; JAX's bf16 model dtype against
torch.autocast, which round different ops to bfloat16): loss columns
within 5e-2 relative (measured 2.7e-2), metrics within 2e-3 (measured 7.9e-5),
and every training forward of the CLI hands its loss bfloat16 outputs (float32
ones under --dtype f32).
Resuming: a run interrupted after epoch 1 and resumed from its last.pt
equals the uninterrupted run exactly (results.csv and every weight).
"""

import importlib.util
import json
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import ROOT, TINY_SEG, TRAIN_SHAPES, primed_tiny, write_yolo_split
from yolo_dual_tpu.train.checkpoint import export_torch_state_dict
from yolo_dual_tpu_torch.segment import train as port_train

pytest.importorskip("cv2")
HYP_YAML = ROOT / "yolo_dual_tpu" / "configs" / "hyps" / "hyp.scratch-low.yaml"


def _jax_cli():
    spec = importlib.util.spec_from_file_location("seg_train_vs_port", str(ROOT / "segment/train.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_set(tmp_path_factory):
    """The dataset, both data files, both configs and the shared weights."""
    root = tmp_path_factory.mktemp("train_cli")
    write_yolo_split(root, "train", 12, TRAIN_SHAPES, seed=7)
    write_yolo_split(root, "val", 6, ((48, 64),), seed=8)
    for side, name, dump in (("jax", "data.yaml", yaml.safe_dump), ("port", "data.json", json.dumps)):
        (root / side / name).write_text(dump(dict(path=str(root / side), train="images/train",
                                                  val="images/val", nc=3, names=["a", "b", "c"])))
    (root / "tiny.yaml").write_text(yaml.safe_dump(TINY_SEG))
    (root / "tiny.json").write_text(json.dumps(TINY_SEG))
    jm, v = primed_tiny()
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in export_torch_state_dict(v, jm.spec).items()},
               root / "tiny.pt")
    return root


def _args(root, dtype, epochs=2):
    return ["--hyp", str(HYP_YAML), "--epochs", str(epochs), "--batch-size", "4", "--imgsz", "64",
            "--seed", "1", "--nbs", "8", "--weights", str(root / "tiny.pt"), "--dtype", dtype,
            "--name", "exp"]


def _port_args(root, dtype, project, epochs=2):
    return _args(root, dtype, epochs) + ["--cfg", str(root / "tiny.json"), "--data",
                                         str(root / "port" / "data.json"), "--project",
                                         str(project), "--device", "cpu"]


def _results(run_dir):
    return np.loadtxt(run_dir / "results.csv", delimiter=",", skiprows=1, ndmin=2)


@pytest.mark.parametrize("dtype, loss_rtol, metric_atol", [("f32", 4e-3, 1e-3), ("bf16", 5e-2, 2e-3)])
def test_cli_matches_jax(run_set, tmp_path, monkeypatch, dtype, loss_rtol, metric_atol):
    jax_train = _jax_cli()
    jax_train.train(jax_train.parse_opt(
        _args(run_set, dtype) + ["--cfg", str(run_set / "tiny.yaml"), "--data",
                                 str(run_set / "jax" / "data.yaml"), "--project", str(tmp_path / "jax")]))
    seen = []  # the dtype of the model's output that each loss call receives
    loss_call = port_train.ComputeSegmentLoss.__call__

    def spy(self, preds, *a):
        seen.append(preds[1].dtype)
        return loss_call(self, preds, *a)
    monkeypatch.setattr(port_train.ComputeSegmentLoss, "__call__", spy)
    port_train.main(_port_args(run_set, dtype, tmp_path / "port"))
    assert seen and set(seen) == {torch.bfloat16 if dtype == "bf16" else torch.float32}, seen
    want, got = _results(tmp_path / "jax" / "exp"), _results(tmp_path / "port" / "exp")
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_array_equal(got[:, 0], [0, 1])
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=loss_rtol)
    np.testing.assert_allclose(got[:, 5:], want[:, 5:], rtol=0, atol=metric_atol)
    assert want[:, 5:].max() > 0  # the primed model finds some of the boxes
    run = tmp_path / "port" / "exp"
    last, best = (port_train.load_checkpoint(run / f) for f in ("last.pt", "best.pt"))
    assert last["epoch"] == 1 and last["optimizer"]["count"] == 3 and last["updates"] == 3
    assert best["optimizer"] is None and best["epoch"] == -1
    assert set(best["model"]) == set(last["ema"])
    assert json.loads((run / "opt.json").read_text())["dtype"] == dtype
    assert json.loads((run / "hyp.json").read_text()) == yaml.safe_load(HYP_YAML.read_text())


@pytest.fixture
def one_thread():
    """torch on one CPU thread: some CPU kernels accumulate in an order that
    depends on how the machine schedules their threads, which moves float32
    sums in their last bits from one run to the next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_continues_exactly(run_set, tmp_path, one_thread):
    """A run interrupted after epoch 1 (its last.pt written), resumed with a
    bare --resume, against the uninterrupted 3-epoch run; then the bare
    --resume semantics of tests/test_train_cli.py: the run's opt.json supplies
    cfg/data/imgsz/batch, the typed --epochs wins, results.csv grows, no new
    run directory."""
    port_train.main(_port_args(run_set, "f32", tmp_path / "a", epochs=3))

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
            port_train.main(_port_args(run_set, "f32", tmp_path / "b", epochs=3))
    finally:
        port_train.save_checkpoint = save
    opt = port_train.parse_opt(["--project", str(tmp_path / "b"), "--name", "exp", "--resume",
                                "--device", "cpu"])
    port_train.train(opt)
    assert opt.epochs == 3 and opt.imgsz == 64 and opt.batch_size == 4
    a, b = tmp_path / "a" / "exp", tmp_path / "b" / "exp"
    assert (b / "results.csv").read_text() == (a / "results.csv").read_text()
    la, lb = (port_train.load_checkpoint(d / "last.pt") for d in (a, b))
    for key in ("model", "ema"):
        assert all(torch.equal(la[key][k], lb[key][k]) for k in la[key]), key
    assert la["optimizer"]["count"] == lb["optimizer"]["count"] and la["updates"] == lb["updates"]

    opt = port_train.parse_opt(["--project", str(tmp_path / "b"), "--name", "exp",
                                "--epochs", "4", "--resume", "--device", "cpu"])
    port_train.train(opt)
    assert opt.cfg == str(run_set / "tiny.json") and opt.data == str(run_set / "port" / "data.json")
    assert opt.epochs == 4, "explicit --epochs was overridden by the restored opt"
    assert not (tmp_path / "b" / "exp2").exists(), "bare --resume created a new run dir"
    np.testing.assert_array_equal(_results(b)[:, 0], [0, 1, 2, 3])


def test_cli_refuses_what_is_not_ported(run_set, tmp_path):
    base = _port_args(run_set, "f32", tmp_path, epochs=1)
    # --no-device-aug, --image-weights, --remat and --cache disk run
    # (tests/test_torch_port_train_flags.py); so do --data-parallel (in one
    # process: as without it), --sync-bn, --loggers (TensorBoard; wandb is a
    # no-op without its package) and --evolve
    port_train.main(base)
    port_train.main(base + ["--data-parallel", "--sync-bn", "--loggers", "wandb", "--name", "dp"])
    np.testing.assert_array_equal(_results(tmp_path / "dp"), _results(tmp_path / "exp"))
    assert (tmp_path / "dp" / "labels.jpg").exists() and (tmp_path / "dp" / "results.png").exists()
    assert list((tmp_path / "dp").glob("events.out.tfevents.*"))
    port_train.main(base + ["--evolve", "2", "--noplots"])
    evolve_dir = tmp_path / "exp-evolve"
    rows = np.loadtxt(evolve_dir / "evolve.csv", delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape[0] == 2 and (evolve_dir / "evolve.png").exists()
    from yolo_dual_tpu.utils.evolve import mutate as jax_mutate
    assert json.loads((evolve_dir / "hyp_gen0.json").read_text()) == \
        jax_mutate(yaml.safe_load(HYP_YAML.read_text()), evolve_dir / "absent.csv", seed=0)
    jax_opt = vars(_jax_cli().parse_opt([]))
    port_opt = vars(port_train.parse_opt([]))
    assert set(jax_opt) == set(port_opt)
    differ = {k for k in jax_opt if jax_opt[k] != port_opt[k]}
    assert differ == {"device"}, differ  # the port defaults to cuda
