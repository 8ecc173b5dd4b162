"""The training data path against the JAX package: the mosaic's warp
sampling and label geometry, the numpy copies of OpenCV's resizes, the host
letterbox, YoloDataset's training samples and host-letterbox val samples
through the Loader, mosaic_warp_hsv, the checkpoints, the optimizer's and
EMA's state and freeze_layers.

Tolerances (ROADMAP.md §C):
- the warp matrix and the labels: the same float64 numpy operations,
  rtol 1e-12 (the rotation matrix is a numpy copy of cv2.getRotationMatrix2D);
- INTER_LINEAR (resize_linear_u8) and the letterbox: exact, up and down,
  one and three channels;
- INTER_AREA (resize_area_u8): exact at integer ratios; at others a value
  may be 1 off where OpenCV's float32 sums round the other way: measured
  0.073% (1,075 of 1,466,167 values) of the 60 random shrinks below, held at
  0.1%;
- the training samples: every key exact (tiles, geometry, gains, flips,
  targets), the masks too except where the polygon rasteriser differs from
  cv2.fillPoly: at most POLYGON_PIXEL_SHARE of an instance's pixels (0 in
  every sample here, as in tests/test_torch_port_data.py);
- mosaic_warp_hsv against JAX's jitted one on the CPU: 1e-5 after /255
  (measured 6.0e-7 at 64 px and 1.1e-6 at 96 px).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import IMGSZ, ROOT, TINY_SEG, TRAIN_SHAPES, write_yolo_split
from yolo_dual_tpu.data import augment as jaug
from yolo_dual_tpu.data.dataset import create_dataloader as jax_create_dataloader
from yolo_dual_tpu.kernels.augment import mosaic_warp_hsv as jax_mosaic_warp_hsv
from yolo_dual_tpu_torch.data import augment
from yolo_dual_tpu_torch.data.dataset import create_dataloader
from yolo_dual_tpu_torch.kernels.augment import mosaic_warp_hsv
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.train import checkpoint
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import freeze_layers, smart_optimizer

cv2 = pytest.importorskip("cv2")

HYP = yaml.safe_load((ROOT / "yolo_dual_tpu" / "configs" / "hyps" / "hyp.scratch-low.yaml").read_text())
# every warp term and both flips on
HYP_WARP = dict(HYP, degrees=10.0, shear=5.0, perspective=5e-4, flipud=0.5)
POLYGON_PIXEL_SHARE = 0.0  # of an instance's pixels at mask_ratio 4, as measured here
AREA_OFF_BY_ONE_SHARE = 1e-3


@pytest.mark.parametrize("perspective", [0.0, 1e-3])
def test_warp_matrix_and_labels_match_jax(perspective):
    rng_np = np.random.default_rng(0)
    for seed in range(20):
        kw = dict(degrees=10, translate=0.1, scale=0.5, shear=5, perspective=perspective,
                  border=(-32, -32))
        rj, rp = random.Random(seed), random.Random(seed)
        mj, sj, whj = jaug.sample_perspective_matrix((128, 128), rng=rj, **kw)
        mp, sp, whp = augment.sample_perspective_matrix((128, 128), rng=rp, **kw)
        np.testing.assert_allclose(mp, mj, rtol=1e-12, atol=1e-12)
        assert (sp, whp) == (sj, whj) and rj.getstate() == rp.getstate()
        n = int(rng_np.integers(0, 5))
        targets = np.concatenate([rng_np.integers(0, 3, (n, 1)),
                                  np.sort(rng_np.uniform(0, 128, (n, 2, 2)), 1).reshape(n, 4)],
                                 1).astype(np.float32)
        segs = [rng_np.uniform(0, 128, (int(rng_np.integers(3, 9)), 2)).astype(np.float32)
                for _ in range(n)]
        tj, gj = jaug.apply_perspective_to_labels(mj, sj, perspective, targets.copy(),
                                                  [s.copy() for s in segs], *whj)
        tp, gp = augment.apply_perspective_to_labels(mp, sp, perspective, targets.copy(),
                                                     [s.copy() for s in segs], *whp)
        np.testing.assert_allclose(tp, tj, rtol=1e-12)
        assert len(gp) == len(gj)
        for a, b in zip(gp, gj):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)


def test_resize_copies_match_cv2():
    rng = np.random.default_rng(0)
    off = total = 0
    for t in range(60):
        h, w = rng.integers(10, 300, 2)
        nh, nw = rng.integers(5, 400, 2)
        im = rng.integers(0, 256, (h, w, 3) if t % 2 else (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(augment.resize_linear_u8(im, nh, nw),
                                      cv2.resize(im, (int(nw), int(nh))), err_msg=f"{im.shape}")
        nh, nw = max(1, min(nh, h)), max(1, min(nw, w))
        d = np.abs(augment.resize_area_u8(im, nh, nw).astype(int)
                   - cv2.resize(im, (int(nw), int(nh)), interpolation=cv2.INTER_AREA))
        assert d.max() <= 1
        off, total = off + (d > 0).sum(), total + d.size
    assert off / total < AREA_OFF_BY_ONE_SHARE, off / total
    for h, w, k in ((720, 1280, 2), (480, 640, 2), (90, 120, 3), (128, 96, 4)):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(augment.resize_linear_u8(im, h // k, w // k),
                                      cv2.resize(im, (w // k, h // k)))
        np.testing.assert_array_equal(augment.resize_area_u8(im, h // k, w // k),
                                      cv2.resize(im, (w // k, h // k),
                                                 interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("scaleup", [True, False])
def test_letterbox_matches_jax(scaleup):
    rng = np.random.default_rng(1)
    for h, w in ((48, 64), (90, 120), (40, 30), (64, 64), (33, 100), (65, 64), (63, 65)):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = jaug.letterbox(im, 64, auto=False, scaleup=scaleup)
        got = augment.letterbox(im, 64, scaleup=scaleup)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def _loaders(root, split, augment_, hyp, overlap, bs=4, seed=3):
    kw = dict(hyp=hyp, augment=augment_, shuffle=augment_, mask_downsample_ratio=4,
              overlap_mask=overlap, seed=seed)
    jl, _ = jax_create_dataloader(str(root / "jax" / "images" / split), IMGSZ, bs, task="segment",
                                  device_aug=augment_, **kw)
    jl.num_shards, jl.shard_index = 1, 0
    pl, _ = create_dataloader(str(root / "port" / "images" / split), IMGSZ, bs,
                              device_aug=augment_, **kw)
    return jl, pl


def _assert_masks_close(got, want, n):
    """Per instance (overlap planes decoded), the share of its pixels that differ."""
    if got.ndim == 3:  # overlap-encoded (bs, h, w)
        got = got[:, None] == np.arange(1, n + 1)[:, None, None]
        want = want[:, None] == np.arange(1, n + 1)[:, None, None]
    area = want.sum((-1, -2))
    share = (got != want).sum((-1, -2))[area > 0] / area[area > 0]
    assert share.max(initial=0) <= POLYGON_PIXEL_SHARE, share.max()
    assert not (got[area == 0]).any()


KEYS = ("targets", "tmask", "shape0", "ratio_pad", "index")
AUG_KEYS = ("aug_tiles", "aug_dst", "aug_off", "aug_invm", "aug_hsv", "aug_flips")


@pytest.mark.parametrize("hyp", [HYP, HYP_WARP], ids=["scratch-low", "warp"])
def test_training_batches_match_jax(tmp_path, hyp):
    """YoloDataset(augment=True, device_aug=True) through the Loader
    (overlap masks) against JAX's, every batch of two shuffled epochs in the
    loader's order; then a dataset built again from the port's label cache
    against a fresh JAX one."""
    write_yolo_split(tmp_path, "train", 10, TRAIN_SHAPES, seed=4)
    for rebuild in (False, True):
        jl, pl = _loaders(tmp_path, "train", True, hyp, True)
        assert pl.dataset.im_files == [f.replace("jax", "port").replace(".png", ".npy")
                                       for f in jl.dataset.im_files]
        if rebuild:  # the second read of the port's cache
            assert (tmp_path / "port" / "labels" / "train.cache").is_file()
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(pb) == len(jb) == 3
            for want, got in zip(jb, pb):
                assert set(got) == set(want)
                for k in AUG_KEYS + KEYS + ("n_valid",):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                    assert got[k].dtype == want[k].dtype, k
                assert got["masks"].shape == want["masks"].shape
                _assert_masks_close(got["masks"], want["masks"], pl.dataset.max_labels)
            assert pl.dataset.rng.getstate() == jl.dataset.rng.getstate()
    assert any(b["aug_flips"].any() for b in pb) and any(b["tmask"].any() for b in pb)


def test_training_instance_masks_match_jax(tmp_path):
    """overlap=False, sample by sample in the loader's order of two epochs.
    JAX gives a sample without labels a (h, w) plane where the others have
    (M, h, w), so its Loader cannot stack them (ROADMAP.md §C); the port gives
    every sample (M, h, w)."""
    write_yolo_split(tmp_path, "train", 10, TRAIN_SHAPES, seed=6)
    jl, pl = _loaders(tmp_path, "train", True, HYP_WARP, False)
    jds, pds = jl.dataset, pl.dataset
    M, empty = pds.max_labels, 0
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        order = [i for chunk in jl._chunks() for i in chunk]
        assert pl._indices() == order
        for i in order:
            want, got = jds[i], pds[i]
            for k in AUG_KEYS + KEYS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["masks"].shape == (M, IMGSZ // 4, IMGSZ // 4)
            if want["masks"].ndim == 2:
                empty += 1
                assert not got["masks"].any() and not want["masks"].any()
            else:
                _assert_masks_close(got["masks"], want["masks"], M)
    assert empty < len(order)


def test_host_letterbox_val_samples_match_jax(tmp_path):
    """The eval branch (augment=False, device_preprocess=False): frames
    resized by load_image (INTER_AREA or INTER_LINEAR) and letterboxed."""
    write_yolo_split(tmp_path, "val", 8, TRAIN_SHAPES, seed=5)
    jl, pl = _loaders(tmp_path, "val", False, HYP, True, bs=3)
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == 3
    off = 0
    for want, got in zip(jb, pb):
        assert set(got) == set(want) and "image" in got
        for k in KEYS + ("n_valid",):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        d = np.abs(got["image"].astype(int) - want["image"])
        assert d.max() <= 1
        off += (d > 0).sum()
        _assert_masks_close(got["masks"], want["masks"], pl.dataset.max_labels)
    assert off / sum(b["image"].size for b in pb) < AREA_OFF_BY_ONE_SHARE


@pytest.mark.parametrize("out_size", [64, 96])
def test_mosaic_warp_hsv_matches_jax(out_size):
    """Random warps of each sample's four tiles, flips and HSV gains (one
    sample at the identity gains), against JAX's jitted function."""
    rng = np.random.default_rng(out_size)
    B, s = 4, 64
    tiles = rng.integers(0, 256, (B, 4, s, s, 3), dtype=np.uint8)
    dst = np.zeros((B, 4, 4), np.float32)
    for b in range(B):
        xc, yc = rng.integers(s // 2, 3 * s // 2, 2)
        dst[b] = [[max(xc - s, 0), max(yc - s, 0), xc, yc], [xc, max(yc - s, 0), min(xc + s, 2 * s), yc],
                  [max(xc - s, 0), yc, xc, min(2 * s, yc + s)], [xc, yc, min(xc + s, 2 * s), min(2 * s, yc + s)]]
    off = rng.uniform(-s, 0, (B, 4, 2)).round().astype(np.float32)
    inv = np.stack([np.linalg.inv(augment.sample_perspective_matrix(
        (2 * s, 2 * s), degrees=10, translate=0.1, scale=0.5, shear=5, perspective=1e-3,
        border=(-s // 2, -s // 2), rng=random.Random(b))[0]) for b in range(B)]).astype(np.float32)
    gains = (rng.uniform(-1, 1, (B, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32)
    gains[0] = 1
    flips = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], bool)
    want = np.asarray(jax_mosaic_warp_hsv(*(jnp.asarray(a) for a in (tiles, dst, off, inv, gains,
                                                                    flips)), out_size=out_size))
    got = mosaic_warp_hsv(*(torch.from_numpy(a) for a in (tiles, dst, off, inv, gains, flips)),
                          out_size=out_size)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _tiny_training(accumulate=2):
    model = SegmentationModel(TINY_SEG, device="cpu")
    opt = smart_optimizer(model, "SGD", HYP, epochs=3, steps_per_epoch=4, accumulate=accumulate,
                          total_batch_size=4)
    return model, opt, ModelEMA(model)


def _step(model, opt, ema, seed):
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (2, 3, IMGSZ, IMGSZ))
                         .astype(np.float32))
    model.train().zero_grad()
    levels, protos = model(x, decode=False)
    (sum(lv.square().mean() for lv in levels) + protos.mean()).backward()
    if opt.step():
        ema.update(model)


def test_checkpoint_round_trip_restores_training(tmp_path):
    """model, EMA (weights and count), optimizer (counters, accumulator,
    moments) saved mid-cycle and loaded into fresh objects continue exactly
    as the originals; strip_optimizer keeps the EMA weights; partial_load
    and load_weights take the shape-matching entries."""
    model, opt, ema = _tiny_training()
    for i in range(3):
        _step(model, opt, ema, i)
    ckpt = {"model": model.state_dict(), "ema": ema.ema.state_dict(), "updates": ema.updates,
            "optimizer": opt.state_dict(), "epoch": 0, "best_fitness": 0.5,
            "data_rng": random.Random(1).getstate()}
    checkpoint.save_checkpoint(tmp_path / "last.pt", ckpt)
    m2, o2, e2 = _tiny_training()
    back = checkpoint.load_checkpoint(tmp_path / "last.pt")
    m2.load_state_dict(back["model"])
    e2.load_state_dict({"model": back["ema"], "updates": back["updates"]})
    o2.load_state_dict(back["optimizer"])
    assert (o2.count, o2.mini_step, e2.updates) == (opt.count, opt.mini_step, ema.updates) == (1, 1, 1)
    assert random.Random().setstate(back["data_rng"]) is None
    for i in range(3, 6):
        _step(model, opt, ema, i)
        _step(m2, o2, e2, i)
    for a, b in ((model, m2), (ema.ema, e2.ema)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    checkpoint.strip_optimizer(tmp_path / "last.pt", tmp_path / "best.pt")
    best = checkpoint.load_checkpoint(tmp_path / "best.pt")
    assert best["optimizer"] is None and best["ema"] is None and best["epoch"] == -1
    assert all(torch.equal(best["model"][k], v) for k, v in back["ema"].items())
    m3 = checkpoint.partial_load(SegmentationModel(dict(TINY_SEG, nc=5), device="cpu"),
                                 tmp_path / "last.pt")
    head = "model.5.m.0.weight"  # the class count changes the detect convs: not loaded
    assert m3.state_dict()[head].shape != back["ema"][head].shape
    assert torch.equal(m3.state_dict()["model.0.conv.weight"], back["ema"]["model.0.conv.weight"])
    with pytest.raises(ValueError, match="match no entry"):
        checkpoint.load_weights(m3, {"other.weight": torch.zeros(3)})


def test_freeze_layers_keeps_frozen_weights():
    """--freeze 2: layers 0 and 1 keep their weights through real steps (their
    moments still move, as under JAX's zeroed updates); the others move."""
    model, opt, ema = _tiny_training(accumulate=1)
    freeze_layers(opt, [2])
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        _step(model, opt, ema, i)
    for name, p in model.named_parameters():
        frozen = name.split(".")[1] in ("0", "1")
        assert torch.equal(p, start[name]) == frozen, name
    assert any(m.abs().sum() > 0 for m, f in zip(opt.m1["g0"], opt.frozen["g0"]) if f)
