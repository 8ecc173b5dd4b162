"""The training and validation flags of the host route against the JAX
package: rect aspect buckets (bucket_of, the bucket shapes, the Loader's
chunks and the letterboxed samples), --image-weights (the class and image
weights, the Loader's weighted draws), --remat (the trainer's recomputed
forward), the trainer's per-step dropout generator, the train CLI on the host
route with the published hyp.scratch-high, and segment.val's --rect, --task
and --verbose.

Tolerances:
- rect buckets, chunks and samples, the weights and the weighted draws: exact,
  but for the frames INTER_AREA shrinks: a value off by 1 on at most 0.1%
  of them (measured 0.035%; ROADMAP.md §C);
- --remat on the primed TINY_SEG (float32, CPU): the port's step equals its
  own plain step bit for bit (loss items, every gradient, the BatchNorm
  statistics and batch counts updated once). JAX's own remat step raises
  (its jax.checkpoint is handed flax's `mutable` list as a traced argument),
  so the port's remat step is held against JAX's plain step, whose values
  jax.checkpoint would not change: the loss items within 1e-4 relative, each
  gradient within 1e-3 of its largest magnitude and the statistics within
  1e-4;
- the train CLI (--no-device-aug --hyp hyp.scratch-high --image-weights
  --cache disk --rect --nosave, 2 epochs at bs 4, 64 px, f32) against JAX's
  segment/train.py: the loss columns within 4e-3 relative and the val
  metrics within 1e-3, as tests/test_torch_port_train_cli.py holds the
  device route; the epoch-1 draws are the weighted ones of both;
- segment.val --rect --task train and --task speed: the 8 metrics and the
  per-class maps within 1e-4 of JAX's segment/val.py run.
"""

import importlib.util
import json
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import (IMGSZ, ROOT, TINY_NC, TINY_NM, TINY_SEG, TRAIN_SHAPES, port_model,
                               primed_tiny, write_yolo_split)
from yolo_dual_tpu.data.dataset import create_dataloader as jax_create_dataloader
from yolo_dual_tpu.data.loader import Loader as JaxLoader
from yolo_dual_tpu.losses import ComputeSegmentLoss as JComputeSegmentLoss
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu.train.checkpoint import export_torch_state_dict
from yolo_dual_tpu.utils import general as jgeneral
from yolo_dual_tpu_torch.data.dataset import YoloDataset, bucket_index, bucket_shape, create_dataloader
from yolo_dual_tpu_torch.data.loader import Loader
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.losses.segment import ComputeSegmentLoss
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.segment import train as port_train
from yolo_dual_tpu_torch.segment import val as port_val
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import smart_optimizer
from yolo_dual_tpu_torch.train.trainer import Trainer
from yolo_dual_tpu_torch.utils import general

pytest.importorskip("cv2")
HYPS = ROOT / "yolo_dual_tpu" / "configs" / "hyps"
HIGH = yaml.safe_load((HYPS / "hyp.scratch-high.yaml").read_text())
# (h, w) frames of every bucket at 128 px: wide 0.5 and 0.7, square, tall 1.4 and 2.0,
# one wider and one taller than any bucket
RECT_SHAPES = ((60, 128), (80, 128), (80, 110), (64, 64), (100, 90), (120, 80), (128, 60),
               (30, 200), (200, 40))
RECT_IMGSZ = 128
AREA_OFF_BY_ONE_SHARE = 1e-3  # INTER_AREA's shrinks (tests/test_torch_port_train_data.py)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_bucket_shapes_and_index_match_jax(tmp_path):
    write_yolo_split(tmp_path, "val", len(RECT_SHAPES), RECT_SHAPES, seed=9)
    jds = jax_create_dataloader(str(tmp_path / "jax" / "images" / "val"), RECT_IMGSZ, 3,
                                rect=True, mask_downsample_ratio=4, overlap_mask=True,
                                task="segment")[1]
    pds = YoloDataset(str(tmp_path / "port" / "images" / "val"), imgsz=RECT_IMGSZ, rect=True)
    assert pds.bucket_shapes == jds.bucket_shapes
    np.testing.assert_array_equal(pds.bucket_of, jds.bucket_of)
    assert set(pds.bucket_of.tolist()) == set(range(len(YoloDataset.BUCKET_ASPECTS)))
    for stride in (32, 64):
        for imgsz in (64, 320, 640):
            assert [bucket_shape(a, imgsz, stride) for a in YoloDataset.BUCKET_ASPECTS] == \
                jax_create_dataloader(str(tmp_path / "jax" / "images" / "val"), imgsz, 3,
                                      stride=stride, rect=True, mask_downsample_ratio=4,
                                      task="segment")[1].bucket_shapes
    # wide frames: the smallest bucket aspect at or above h/w; tall: the largest at or below
    for r, b in ((0.2, 0), (0.5, 0), (0.51, 1), (0.7, 1), (0.71, 2), (1.0, 2), (1.39, 2),
                 (1.4, 3), (1.99, 3), (2.0, 4), (5.0, 4)):
        assert bucket_index(r, YoloDataset.BUCKET_ASPECTS) == b, r
    # augment ignores rect: the mosaic is square
    assert YoloDataset(str(tmp_path / "port" / "images" / "val"), imgsz=RECT_IMGSZ, rect=True,
                       augment=True, hyp=HIGH).bucket_of is None


@pytest.mark.parametrize("shuffle", [False, True])
def test_rect_chunks_and_samples_match_jax(tmp_path, shuffle):
    """The Loader's chunks never straddle a bucket, and every batch of the
    host letterbox at the bucket shapes equals JAX's (two epochs)."""
    write_yolo_split(tmp_path, "val", 14, RECT_SHAPES, seed=10)
    kw = dict(rect=True, mask_downsample_ratio=4, overlap_mask=True, task="segment",
              shuffle=shuffle, seed=2)
    jl, _ = jax_create_dataloader(str(tmp_path / "jax" / "images" / "val"), RECT_IMGSZ, 3, **kw)
    jl.num_shards, jl.shard_index = 1, 0
    pl, pds = create_dataloader(str(tmp_path / "port" / "images" / "val"), RECT_IMGSZ, 3, **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        chunks = list(pl._chunks())
        assert chunks == list(jl._chunks()) and len(pl) == len(jl)
        assert all(len({int(pds.bucket_of[i]) for i in c}) == 1 for c in chunks)
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == len(chunks) > len(pds.bucket_shapes)
        for want, got in zip(jb, pb):
            assert set(got) == set(want)
            for k in want:
                if k != "image":
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            off = np.abs(got["image"].astype(int) - want["image"])
            assert off.max() <= 1 and (off > 0).mean() <= AREA_OFF_BY_ONE_SHARE
    assert {b["image"].shape[1:3] for b in pb} == set(pds.bucket_shapes)


def test_class_and_image_weights_match_jax():
    rng = np.random.default_rng(0)
    labels = [np.concatenate([rng.integers(0, 5, (n, 1)), rng.uniform(0, 1, (n, 4))], 1)
              for n in (3, 0, 7, 1, 2)]
    for lab in (labels, [np.zeros((0, 5))], []):
        np.testing.assert_array_equal(general.labels_to_class_weights(lab, 6),
                                      jgeneral.labels_to_class_weights(lab, 6))
    cw = general.labels_to_class_weights(labels, 6) * (1 - np.linspace(0, 0.5, 6)) ** 2 / 6
    for c in (None, cw):
        np.testing.assert_array_equal(general.labels_to_image_weights(labels, 6, c),
                                      jgeneral.labels_to_image_weights(labels, 6, c))


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int32(i)}


@pytest.mark.parametrize("weights", ["skewed", "zero"])
def test_sample_weights_draw_as_jax(weights):
    """Three epochs of weighted draws with replacement (all-zero weights fall
    back to uniform), and the chunks they make."""
    n = 11
    w = np.arange(n, dtype=np.float64) ** 2 if weights == "skewed" else np.zeros(n)
    jl = JaxLoader(_Range(n), batch_size=4, shuffle=True, seed=7, num_shards=1, shard_index=0)
    pl = Loader(_Range(n), batch_size=4, shuffle=True, seed=7)
    jl.sample_weights = pl.sample_weights = w
    draws = []
    for epoch in range(3):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert pl._indices() == jl._indices()
        assert [b["i"].tolist() for b in pl] == [b["i"].tolist() for b in jl]
        draws.append(pl._indices())
    assert draws[0] != draws[1] and len(draws[0]) == n
    if weights == "skewed":
        assert 0 not in sum(draws, [])


def _remat_batch(bs=2):
    rng = np.random.default_rng(0)
    targets = np.zeros((bs, 4, 5), np.float32)
    targets[:, 0] = [0, 0.5, 0.5, 0.3, 0.3]
    targets[:, 1] = [1, 0.3, 0.3, 0.2, 0.2]
    tmask = np.zeros((bs, 4), bool)
    tmask[:, :2] = True
    masks = np.zeros((bs, 16, 16), np.float32)
    masks[:, 6:10, 6:10], masks[:, 3:6, 3:6] = 1, 2
    return {"image": rng.integers(0, 256, (bs, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "targets": targets, "tmask": tmask, "masks": masks}


def test_remat_step_matches_the_plain_step_and_jax():
    jm, v = primed_tiny()
    batch = _remat_batch()
    out = {}
    for remat in (False, True):
        model = port_model(v)
        head = model.model[-1]
        loss = ComputeSegmentLoss(head.anchors, head.strides, TINY_NC, TINY_NM, HIGH, overlap=True)
        opt = smart_optimizer(model, "SGD", HIGH, epochs=10, steps_per_epoch=5, total_batch_size=2)
        tr = Trainer(model, loss, opt, ModelEMA(model), remat=remat)
        state, m = tr.train_step(tr.init_state(), batch)
        out[remat] = (m["items"], {k: p.grad for k, p in model.named_parameters()},
                      model.state_dict())
    (items, grads, sd), (ritems, rgrads, rsd) = out[False], out[True]
    assert torch.equal(items, ritems)
    for k in grads:
        assert torch.equal(grads[k], rgrads[k]), k
    for k in sd:
        assert torch.equal(sd[k], rsd[k]), k
        if k.endswith("num_batches_tracked"):
            assert rsd[k].item() == 1, k

    kw = jm.spec.layers[-1].kw()
    jloss = JComputeSegmentLoss(kw["anchors"], kw["strides"], TINY_NC, TINY_NM, HIGH, overlap=True)
    tx = j_smart_optimizer(v["params"], "SGD", HIGH, epochs=10, steps_per_epoch=5,
                           total_batch_size=2)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    jtr = JTrainer(jm, jloss, tx, task="segment", remat=True)
    s0 = jtr.init_state(v)
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jtr._forward_loss(s0.params, s0.batch_stats, jb)
    jtr.remat = False
    (_, (jitems, new_bs)), jgrads = jax.jit(jax.value_and_grad(jtr._forward_loss, has_aux=True))(
        s0.params, s0.batch_stats, jb)
    np.testing.assert_allclose(ritems.numpy(), np.asarray(jitems), rtol=1e-4)
    for k, g in state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)}).items():
        scale = max(g.abs().max().item(), 1e-12)
        assert (rgrads[k] - g).abs().max().item() <= 1e-3 * scale, k
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, s0.params),
                                 "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)})
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(rsd[k].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=k)


def test_dropout_generator_is_seeded_by_the_step():
    """Trainer(dropout=True): the same micro-step draws the same mask in two
    trainers from the same weights, the next step another one, the recomputed
    forward of --remat the same one, and torch's global generator is left
    where it was."""
    from yolo_dual_tpu_torch.models.model import ClassificationModel
    cfg = dict(nc=5, depth_multiple=1.0, width_multiple=1.0,
               backbone=[[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]], head=[])
    x = torch.rand(4, 16, 16, 3)
    labels = torch.tensor([0, 1, 2, 3])

    def run(remat, steps):
        model = ClassificationModel(cfg, nc=5, cutoff=2, dropout=0.5, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
        opt = smart_optimizer(model, "SGD", dict(lr0=0.0, lrf=1.0, momentum=0.9,
                                                 weight_decay=0.0, warmup_epochs=0.0),
                              epochs=1, steps_per_epoch=10)
        tr = Trainer(model, lambda lg, lb: (torch.nn.functional.cross_entropy(lg, lb.long()),
                                            (lg.sum(), lg.sum())),
                     opt, task="classify", dropout=True, remat=remat)
        state, losses = tr.init_state(), []
        for _ in range(steps):
            state, m = tr.train_step(state, {"image": x, "label": labels})
            losses.append(m["loss"].item())
        return losses, [p.grad.clone() for p in model.parameters()]
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    (a, ga), (b, _), (r, gr) = run(False, 2), run(False, 2), run(True, 2)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert a == b == r and a[0] != a[1]
    assert all(torch.equal(g, h) for g, h in zip(ga, gr))


@pytest.fixture(scope="module")
def run_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_flags")
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


def _results(run_dir):
    return np.loadtxt(run_dir / "results.csv", delimiter=",", skiprows=1, ndmin=2)


def test_train_cli_host_route_matches_jax(run_set, tmp_path, monkeypatch):
    """segment.train --no-device-aug --hyp hyp.scratch-high --image-weights
    --cache disk --rect against JAX's segment/train.py, 2 epochs (--nosave:
    one checkpoint write each, the final one, to keep the test short): the same
    draws (the Loader's weighted indices of both epochs), losses and
    metrics; the run's sample weights follow the per-class mAPs."""
    common = ["--epochs", "2", "--batch-size", "4", "--imgsz", "64", "--seed", "1", "--nbs", "8",
              "--weights", str(run_set / "tiny.pt"), "--dtype", "f32", "--name", "exp",
              "--no-device-aug", "--image-weights", "--cache", "disk", "--rect", "--noplots",
              "--nosave"]
    drawn = {"jax": [], "port": []}
    for side, cls in (("jax", JaxLoader), ("port", Loader)):
        indices = cls._indices

        def spy(self, side=side, indices=indices):
            idx = indices(self)
            if self.shuffle:
                drawn[side].append(idx)
            return idx
        monkeypatch.setattr(cls, "_indices", spy)
    jax_train = _load("seg_train_flags_vs_port", ROOT / "segment" / "train.py")
    jax_train.train(jax_train.parse_opt(common + [
        "--hyp", str(HYPS / "hyp.scratch-high.yaml"), "--cfg", str(run_set / "tiny.yaml"),
        "--data", str(run_set / "jax" / "data.yaml"), "--project", str(tmp_path / "jax")]))
    port_train.main(common + ["--hyp", "hyp.scratch-high.json", "--cfg", str(run_set / "tiny.json"),
                              "--data", str(run_set / "port" / "data.json"), "--project",
                              str(tmp_path / "port"), "--device", "cpu"])
    assert drawn["port"] == drawn["jax"] and len(drawn["port"]) >= 2
    assert any(len(set(d)) < len(d) for d in drawn["port"])  # drawn with replacement
    want, got = _results(tmp_path / "jax" / "exp"), _results(tmp_path / "port" / "exp")
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=4e-3)
    np.testing.assert_allclose(got[:, 5:], want[:, 5:], rtol=0, atol=1e-3)
    assert np.isfinite(got).all()
    ck = port_train.load_checkpoint(tmp_path / "port" / "exp" / "last.pt")
    assert ck["data_np_rng"] is not None and ck["epoch"] == 1


def test_train_cli_remat_runs_an_epoch(run_set, tmp_path):
    port_train.main(["--epochs", "1", "--batch-size", "4", "--imgsz", "64", "--nbs", "8",
                     "--weights", str(run_set / "tiny.pt"), "--dtype", "f32", "--remat",
                     "--hyp", "hyp.scratch-med.json", "--cfg", str(run_set / "tiny.json"),
                     "--data", str(run_set / "port" / "data.json"), "--project", str(tmp_path),
                     "--device", "cpu", "--noplots"])
    assert np.isfinite(_results(tmp_path / "exp")).all()


@pytest.fixture(scope="module")
def rect_set(tmp_path_factory):
    """Frames of three buckets at 64 px (wide 0.5, square, tall 2.0),
    labelled as rectangles with the primed TINY model's own boxes so both
    metric halves are non-zero; a train split that --task train reads."""
    root = tmp_path_factory.mktemp("rect_val")
    shapes = ((30, 64), (64, 64), (64, 30), (40, 60))
    for split in ("train", "val"):
        write_yolo_split(root, split, 6, shapes, seed=11 if split == "train" else 12)
    jm, v = primed_tiny()
    model = port_model(v).eval()
    head = model.model[-1]
    for split in ("train", "val"):
        for f in sorted((root / "port" / "images" / split).glob("*.npy")):
            im = np.load(f)
            h0, w0 = im.shape[:2]
            x = letterbox_normalize(torch.from_numpy(im)[None], IMGSZ, scaleup=True)
            r = IMGSZ / max(h0, w0)
            top, left = (IMGSZ - round(h0 * r)) / 2, (IMGSZ - round(w0 * r)) / 2
            with torch.no_grad():
                levels, _ = model(x, decode=False)
                out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=1e-4,
                                       iou_thres=0.6, max_det=20, nm=TINY_NM)
            lines = []
            for d in out[0, :int(nv[0])].numpy()[:4]:
                x1, x2 = np.clip((d[[0, 2]] - left) / (r * w0), 0, 1)
                y1, y2 = np.clip((d[[1, 3]] - top) / (r * h0), 0, 1)
                if x2 - x1 > 0.05 and y2 - y1 > 0.05:
                    lines.append(f"{int(d[5])} {x1} {y1} {x2} {y1} {x2} {y2} {x1} {y2}")
            for side in ("jax", "port"):
                (root / side / "labels" / split / f"{f.stem}.txt").write_text("\n".join(lines))
    for side, name, dump in (("jax", "data.yaml", yaml.safe_dump), ("port", "data.json", json.dumps)):
        (root / side / name).write_text(dump(dict(path=str(root / side), train="images/train",
                                                  val="images/val", nc=3, names=["a", "b", "c"])))
    (root / "tiny.yaml").write_text(yaml.safe_dump(TINY_SEG))
    (root / "tiny.json").write_text(json.dumps(TINY_SEG))
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in export_torch_state_dict(v, jm.spec).items()},
               root / "tiny.pt")
    return root


@pytest.mark.parametrize("task", ["train", "speed"])
def test_val_cli_rect_task_and_verbose_match_jax(rect_set, task, caplog):
    jax_val = _load("seg_val_flags_vs_port", ROOT / "segment" / "val.py")
    kw = dict(batch_size=2, imgsz=IMGSZ, rect=True, task=task, verbose=True)
    want, want_maps, _ = jax_val.run(data=str(rect_set / "jax" / "data.yaml"),
                                     weights=str(rect_set / "tiny.pt"),
                                     cfg=str(rect_set / "tiny.yaml"), **kw) if task != "speed" \
        else jax_val.run(data=str(rect_set / "jax" / "data.yaml"), weights=str(rect_set / "tiny.pt"),
                         cfg=str(rect_set / "tiny.yaml"), **dict(kw, task="val", conf_thres=0.25,
                                                                 iou_thres=0.45))
    opt = port_val.parse_opt(["--data", str(rect_set / "port" / "data.json"), "--weights",
                              str(rect_set / "tiny.pt"), "--cfg", str(rect_set / "tiny.json"),
                              "--batch-size", "2", "--imgsz", str(IMGSZ), "--rect", "--task", task,
                              "--verbose", "--device", "cpu", "--workers", "3", "--dnn",
                              "--no-download", "--cache"])
    with caplog.at_level(logging.INFO, logger="yolo_dual_tpu_torch"):
        logger = logging.getLogger("yolo_dual_tpu_torch")
        logger.addHandler(caplog.handler)
        try:
            got, got_maps, _ = port_val.main(opt)
        finally:
            logger.removeHandler(caplog.handler)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05 and got[6] > 0.05, got
    rows = [r.getMessage().split() for r in caplog.records]
    assert any(r and r[0] in ("a", "b", "c") and len(r) == 11 for r in rows)  # per-class rows


def test_val_cli_study_writes_a_row_a_size(rect_set, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_val, "STUDY_SIZES", (64, 96))
    opt = port_val.parse_opt(["--data", str(rect_set / "port" / "data.json"), "--weights",
                              str(rect_set / "tiny.pt"), "--cfg", str(rect_set / "tiny.json"),
                              "--batch-size", "2", "--task", "study", "--device", "cpu", "--half"])
    rows = port_val.main(opt)
    table = np.loadtxt(tmp_path / "study_data_tiny.txt", ndmin=2)
    assert table.shape == (2, 11)
    np.testing.assert_allclose(table[:, :8], np.asarray(rows)[:, :8], rtol=1e-3, atol=1e-4)
