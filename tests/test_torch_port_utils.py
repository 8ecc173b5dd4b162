"""The port's utils layer against the JAX package's: evolve and the HPO search
bit for bit (the same rows in the same CSV bytes), autoanchor under the same
seeds, prune's masks and sparsity on the same weights, model_info's layers and
parameters (and the GFLOPs gap), the loggers' results.csv and TensorBoard
scalars value for value (read back with tensorboard's EventAccumulator), each
of the ten matplotlib / cv2 plots pixel for pixel on the same numpy inputs;
and the port-only parts: callbacks, remote loggers without their SDKs,
autobatch's pick, profile, trace and check_bf16, and the DCNv3 FLOP formula.

GFLOPs: JAX's model_info reads XLA's cost analysis, which counts only the
convolution taps that fall inside the input (a padding tap is free) and adds
the elementwise operations (BatchNorm, activations, the head's sigmoid);
FlopCounterMode counts every tap of every output, 2 per multiply-add, and
nothing elementwise. The two gaps pull opposite ways: the port's count is
1.008 of JAX's on TINY_SEG at 64 px and 0.979 at 128 px (held within 5%),
1.110 on yolov5n-seg at 64 px and 1.034 at 160 px, where padding taps weigh
more.
"""

import csv
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from torch_port_common import IMGSZ, port_model, primed_tiny
from yolo_dual_tpu.utils import autoanchor as jaa
from yolo_dual_tpu.utils import evolve as jev
from yolo_dual_tpu.utils import hpo as jhpo
from yolo_dual_tpu.utils import plots as jplots
from yolo_dual_tpu.utils import prune as jprune
from yolo_dual_tpu.utils.loggers import Loggers as JLoggers
from yolo_dual_tpu.utils.profiling import check_bf16 as jax_check_bf16
from yolo_dual_tpu.utils.profiling import model_info as jax_model_info
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.utils import autoanchor as paa
from yolo_dual_tpu_torch.utils import evolve as pev
from yolo_dual_tpu_torch.utils import hpo as phpo
from yolo_dual_tpu_torch.utils import plots as pplots
from yolo_dual_tpu_torch.utils import prune as pprune
from yolo_dual_tpu_torch.utils.autobatch import autobatch
from yolo_dual_tpu_torch.utils.callbacks import HOOKS, Callbacks
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
from yolo_dual_tpu_torch.utils.loggers import SEG_KEYS, Loggers
from yolo_dual_tpu_torch.utils.profiling import (check_bf16, dcnv3_flops, flops_of, model_info,
                                                 profile, trace)
from yolo_dual_tpu_torch.utils.remote_loggers import build_remote_loggers

HYP = load_config(find_cfg("hyp.scratch-low.yaml"))


# --- evolve and HPO -----------------------------------------------------------------------

def test_evolve_mutations_and_csv_match_jax(tmp_path):
    """Five generations of mutate (parents drawn from the growing evolve.csv)
    and print_mutation: the same hyps and the same CSV bytes."""
    rows = {}
    for name, ev in (("jax", jev), ("port", pev)):
        d = tmp_path / name
        d.mkdir()
        hyps = []
        for gen in range(5):
            hyp = ev.mutate(HYP, d / "evolve.csv", seed=gen)
            ev.print_mutation([], [], hyp, d, 0.1 * ((gen * 7) % 5) + 0.01 * gen)
            hyps.append(hyp)
        rows[name] = (hyps, (d / "evolve.csv").read_bytes())
    assert rows["port"] == rows["jax"]
    assert rows["port"][0][0] != HYP and rows["port"][0][3] != rows["port"][0][4]


def _objective(hyp):
    return float(np.cos(hyp["lr0"] * 40) + hyp["momentum"] - abs(hyp["box"] - 0.05))


@pytest.mark.parametrize("strategy", ["random", "evolve"])
def test_hyperparameter_search_matches_jax(tmp_path, strategy):
    """Seven trials (three random, then GA children for "evolve"), and a
    resumed search that adds two: the same history and hpo.csv bytes."""
    out = {}
    for name, hp in (("jax", jhpo), ("port", phpo)):
        d = tmp_path / name
        s = hp.HyperparameterSearch(_objective, strategy=strategy, trials=7, base_hyp=HYP,
                                    save_dir=d, seed=5)
        best = s.run()
        resumed = hp.HyperparameterSearch(_objective, strategy=strategy, trials=9,
                                          base_hyp=HYP, save_dir=d, seed=6).run()
        out[name] = (best, resumed, (d / "hpo.csv").read_bytes())
    assert out["port"] == out["jax"]
    assert phpo.HYP_SPACE == jhpo.HYP_SPACE
    assert phpo.wandb_sweep_config() == jhpo.wandb_sweep_config()
    assert phpo.clip_to_space({"lr0": 5.0, "box": -1}, phpo.HYP_SPACE) == \
        jhpo.clip_to_space({"lr0": 5.0, "box": -1}, jhpo.HYP_SPACE)


def test_hpo_cli_parses_and_gates_providers(monkeypatch):
    from yolo_dual_tpu_torch import hpo as cli
    opt = cli.parse_opt(["--backend", "wandb", "--trials", "2"])
    assert (opt.backend, opt.trials, opt.strategy, opt.device) == ("wandb", 2, "random", "cuda")
    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    with pytest.raises(ImportError):
        cli.main(opt)


# --- autoanchor ---------------------------------------------------------------------------

def _labels(seed, wh_range):
    rng = np.random.default_rng(seed)
    shapes = rng.integers(300, 700, (30, 2))
    labels = []
    for _ in range(30):
        n = int(rng.integers(0, 7))
        labels.append(np.concatenate([np.zeros((n, 1)), rng.uniform(0.3, 0.7, (n, 2)),
                                      rng.uniform(*wh_range, (n, 2))], 1).astype(np.float32))
    return shapes, labels


ANCHORS = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]], np.float32).reshape(3, 3, 2)


@pytest.mark.parametrize("wh_range,scale", [((0.05, 0.6), 1.0), ((0.5, 0.95), 1 / 40)],
                         ids=["good_fit", "bad_fit"])
def test_check_anchors_and_kmean_anchors_match_jax(wh_range, scale):
    shapes, labels = _labels(3, wh_range)
    got = []
    for aa in (jaa, paa):
        np.random.seed(0)  # check_anchors' scale jitter draws from numpy's global stream
        bpr, new = aa.check_anchors(shapes, labels, ANCHORS * scale, stride=[8, 16, 32])
        wh = np.concatenate([lb[:, 3:5] * 500 for lb in labels if len(lb)])
        got.append((bpr, new, aa.kmean_anchors(wh, n=9, gen=300, seed=4),
                    aa.anchor_fitness(ANCHORS.reshape(-1, 2), wh, 0.25)))
    (jb, jn, jk, jf), (pb, pn, pk, pf) = got
    assert pb == jb and pf == jf
    assert (pn is None) == (jn is None) == (scale == 1.0)
    if pn is not None:
        np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(pk, jk)


# --- prune, model_info, profiling ---------------------------------------------------------

@pytest.mark.parametrize("amount", [0.3, 0.75])
def test_prune_masks_and_sparsity_match_jax(amount):
    """TINY_SEG's conv kernels pruned per tensor: the same zeros, the same
    global sparsity over the parameters (biases and BatchNorm affine included,
    no running statistics)."""
    _, v = primed_tiny()
    jpruned, jsp = jprune.prune(v["params"], amount)
    model = port_model(v)
    _, psp = pprune.prune(model, amount)
    assert psp == pytest.approx(jsp, abs=1e-12)
    assert pprune.sparsity(model) == pytest.approx(jprune.sparsity(jpruned), abs=1e-12)
    want = state_dict_from_flax({"params": jpruned, "batch_stats": v["batch_stats"]})
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("imgsz", [64, 128])
def test_model_info_layers_and_parameters_match_jax(imgsz):
    jm, v = primed_tiny()
    jl, jp, jg = jax_model_info(jm, v, imgsz=imgsz)
    pl, pp, pg = model_info(port_model(v), imgsz=imgsz)
    assert (pl, pp) == (jl, jp) == (6, 18256)
    assert pg == pytest.approx(jg, rel=0.05)  # padding taps and elementwise work, see above


def test_dcnv3_flops_are_counted_by_their_formula():
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    d = load_config(find_cfg("yolov5n-seg.json"))
    d["backbone"][8][2] = "C3_DCNV3"
    model = SegmentationModel(d, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(1, 3, 64, 64)
    fwd = lambda t: model(t, decode=False)  # noqa: E731
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(dcnv3_flops(m, o)))
             for m in model.modules() if type(m).__name__ == "DCNv3"]
    plain = flops_of(fwd, x)
    for h in hooks:
        h.remove()
    assert seen == [11 * 2 * 2 * 128 * 9]  # one DCNv3: a 2 x 2 map of 128 channels, 9 points
    assert flops_of(fwd, x, model=model) == plain + seen[0]


def test_profile_trace_and_check_bf16(tmp_path):
    jm, v = primed_tiny()
    model = port_model(v).eval()
    x = torch.zeros(2, 3, IMGSZ, IMGSZ)
    fwd = lambda t: model(t, decode=False)  # noqa: E731
    t_min, t_med, fl = profile(fwd, x, n=3, warmup=1, model=model)
    assert 0 < t_min <= t_med and fl == flops_of(fwd, x)
    out = trace(fwd, x, log_dir=tmp_path / "prof")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0 and len(out) == 2
    assert check_bf16(model, imgsz=IMGSZ) == jax_check_bf16(jm, v, imgsz=IMGSZ) is True


def test_autobatch_picks_the_largest_candidate_that_fits():
    model = port_model(primed_tiny()[1])
    gib = 2 ** 30
    record = {}
    # 16 GiB without CUDA, fraction 0.8: 12.8 GiB; a GiB a sample fits up to 8
    assert autobatch(model, measure=lambda m, bs, s: bs * gib, record=record) == 8
    assert record == {1: gib, 2: 2 * gib, 4: 4 * gib, 8: 8 * gib, 16: 16 * gib}

    def oom_at_4(m, bs, s):
        if bs >= 4:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return bs

    assert autobatch(model, measure=oom_at_4) == 2

    def launch_fails_at_4(m, bs, s):  # not an out-of-memory: raised, not taken as a pick
        if bs >= 4:
            raise RuntimeError("dcnv3_sampling: launch failed")
        return bs

    with pytest.raises(RuntimeError, match="launch failed"):
        autobatch(model, measure=launch_fails_at_4)


# --- callbacks and loggers ----------------------------------------------------------------

def test_callbacks_register_and_run():
    from yolo_dual_tpu.utils.callbacks import HOOKS as JHOOKS
    assert HOOKS == JHOOKS
    cb, seen = Callbacks(), []
    cb.register_action("on_train_end", "a", lambda x: seen.append(("a", x)))
    cb.register_action("on_train_end", "b", lambda x: seen.append(("b", x)))
    cb.run("on_train_end", 3)
    assert seen == [("a", 3), ("b", 3)] and len(cb.get_registered_actions("on_train_end")) == 2
    with pytest.raises(AssertionError):
        cb.register_action("on_nothing", "c", print)


def test_remote_loggers_are_inert_without_their_sdks(monkeypatch, tmp_path):
    for name in ("wandb", "clearml", "comet_ml"):
        monkeypatch.setitem(sys.modules, name, None)
    adapters = build_remote_loggers(["wandb", "clearml", "comet", "unknown"], save_dir=tmp_path)
    assert [type(a).__name__ for a in adapters] == ["WandbLogger", "ClearMLLogger", "CometLogger"]
    for a in adapters:
        assert not a.active
        a.log_metrics({"x": 1.0}, 0)
        a.log_image("t", np.zeros((4, 4, 3), np.uint8), 0)
        a.log_model(tmp_path, 0, True)
        a.finish()


def test_wandb_adapter_routes_metrics_through_a_fake_sdk(monkeypatch, tmp_path):
    calls = []
    run = types.SimpleNamespace(log=lambda m, step: calls.append((m, step)), id="r",
                                finish=lambda: calls.append("finish"))
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=lambda **kw: run))
    lg = Loggers(tmp_path, include=("csv", "wandb"))
    assert lg.wandb is not None
    lg.log_metrics({"train/loss": 1.0}, 3)
    lg.close()
    assert calls == [({"train/loss": 1.0}, 3), "finish"]


def _tb_values(log_dir):
    """{tag: [(step, value)]} of an event file's scalars: simple values (torch's
    SummaryWriter) or scalar tensors (tensorflow's summary writer)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util
    ea = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "tensors": 0})
    ea.Reload()
    tags = ea.Tags()
    out = {t: [(e.step, float(e.value)) for e in ea.Scalars(t)] for t in tags["scalars"]}
    out.update({t: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                    for e in ea.Tensors(t)] for t in tags["tensors"]})
    return out


def test_loggers_csv_and_tensorboard_scalars_match_jax(tmp_path):
    """results.csv (three epochs, then a resumed logger appending a fourth
    under the adopted header) byte for byte, and every TB scalar value for
    value, float32 as both writers store them."""
    rng = np.random.default_rng(0)
    epochs = [dict(zip(SEG_KEYS[:12], rng.uniform(0, 1, 12).tolist())) for _ in range(4)]
    for name, cls in (("jax", JLoggers), ("port", Loggers)):
        lg = cls(tmp_path / name, opt={"epochs": 4}, hyp=HYP, include=("csv", "tb"))
        for e in range(3):
            lg.log_metrics(epochs[e], e)
        lg.close()
        lg = cls(tmp_path / name, include=("csv",))
        lg.on_fit_epoch_end(list(epochs[3].values()), 3, keys=list(epochs[3]))
        lg.close()
    assert (tmp_path / "port" / "results.csv").read_bytes() == \
        (tmp_path / "jax" / "results.csv").read_bytes()
    got, want = _tb_values(tmp_path / "port"), _tb_values(tmp_path / "jax")
    assert got.keys() == want.keys() == set(SEG_KEYS[:12])
    for k, w in want.items():
        assert got[k] == [(s, float(np.float32(x))) for s, x in w] == \
            [(e, float(np.float32(epochs[e][k]))) for e in range(3)], k


# --- the ten plots ------------------------------------------------------------------------

def _pixels(path):
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert im is not None and im.size, path
    return im


def _curves(rng, nc=3):
    px = np.linspace(0, 1, 1000)
    py = [np.sort(rng.uniform(0, 1, 1000))[::-1] for _ in range(nc)]
    ap = rng.uniform(0, 1, (nc, 10))
    return px, py, ap


def _write_results(path, rows=6):
    rng = np.random.default_rng(1)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "box_loss", "seg_loss", "obj_loss", "cls_loss", "mAP50_B", "mAP_B",
                    "mAP50_M", "mAP_M", "fitness"])
        for e in range(rows):
            w.writerow([e, *rng.uniform(0, 1, 9)])


def _write_evolve(d):
    for gen in range(6):
        pev.print_mutation([], [], pev.mutate(HYP, d / "evolve.csv", seed=gen), d, 0.1 * gen)


def _write_study(d):
    rng = np.random.default_rng(2)
    np.savetxt(d / "study_data_w.txt", rng.uniform(0, 1, (5, 11)), fmt="%10.4g")


PLOTS = {
    "pr_curve": lambda m, d, rng: m.plot_pr_curve(*_curves(rng), d / "PR.png",
                                                  {0: "a", 1: "b", 2: "c"}),
    "mc_curve": lambda m, d, rng: m.plot_mc_curve(_curves(rng)[0], np.stack(_curves(rng)[1]),
                                                  d / "F1.png", {0: "a", 1: "b", 2: "c"},
                                                  ylabel="F1"),
    "images": lambda m, d, rng: m.plot_images(
        rng.uniform(0, 1, (5, 48, 64, 3)),
        np.array([[0, 1, .5, .5, .3, .4], [2, 0, .3, .6, .2, .2], [4, 2, .7, .2, .4, .3]]),
        fname=d / "images.jpg"),
    "images_and_masks": lambda m, d, rng: m.plot_images_and_masks(
        rng.uniform(0, 1, (4, 32, 32, 3)), np.array([[1, 1, .5, .5, .3, .4]]),
        rng.integers(0, 3, (4, 16, 16)).astype(np.float32), fname=d / "batch.jpg"),
    "results": lambda m, d, rng: (_write_results(d / "results.csv"),
                                  m.plot_results(d / "results.csv", d)),
    "evolve": lambda m, d, rng: (_write_evolve(d), m.plot_evolve(d / "evolve.csv")),
    "val_study": lambda m, d, rng: (_write_study(d),
                                    m.plot_val_study(dir=d, x=[256, 384, 512, 640, 768])),
    "labels": lambda m, d, rng: m.plot_labels(
        np.concatenate([rng.integers(0, 4, (60, 1)), rng.uniform(0.1, 0.9, (60, 4))], 1),
        {0: "a", 1: "b", 2: "c", 3: "d"}, d),
    "imshow_cls": lambda m, d, rng: m.imshow_cls(
        rng.uniform(0, 1, (6, 24, 24, 3)), labels=[0, 1, 2, 0, 1, 2], pred=[0, 2, 2, 1, 1, 0],
        names=["x", "y", "z"], f=d / "cls.jpg"),
    "lr_scheduler": lambda m, d, rng: m.plot_lr_scheduler(
        lambda s: 0.01 * (1 - s / 300) + 1e-4 * (s < 30) * s, 300, d),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plot_pixels_match_jax(tmp_path, name):
    files = {}
    for tag, mod in (("jax", jplots), ("port", pplots)):
        d = tmp_path / tag
        d.mkdir()
        PLOTS[name](mod, d, np.random.default_rng(7))
        files[tag] = sorted(p for p in d.iterdir() if p.suffix in (".png", ".jpg"))
    assert [p.name for p in files["port"]] == [p.name for p in files["jax"]] and files["port"]
    for p, j in zip(files["port"], files["jax"]):
        np.testing.assert_array_equal(_pixels(p), _pixels(j), err_msg=p.name)
