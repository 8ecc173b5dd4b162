"""The host augmentation route of instance-seg (and detect) training against
the JAX package: the numpy copies of OpenCV's colour conversions and
warpPerspective, augment_hsv, random_perspective, copy_paste, mixup, cutout,
the Albumentations adapter, YoloDataset's host route through the Loader,
quad_collate, the published hyps' JSON copies and the box functions the
data path needs.

Tolerances (ROADMAP.md §C):
- COLOR_RGB2HSV (rgb_to_hsv_u8): exact on all 2^24 colours;
  COLOR_HSV2RGB (hsv_to_rgb_u8): exact on all 180 x 256 x 256 HSV values, in
  a row's SIMD blocks (truncated) and in its scalar tail (rounded), so
  augment_hsv is exact;
- warpPerspective (warp_perspective_u8) and random_perspective: exact,
  pixels, labels and polygons;
- copy_paste: labels and polygons exact; its pixels differ only where
  fill_poly's fill differs from cv2.drawContours(FILLED), which fills as
  cv2.fillPoly does: at most FILL_SHARE of the pasted pixels (measured 0 on
  the polygons here; 6 of 176,510,124 pixels, 6.8e-7 of the filled area, on
  300 random polygons of 3-40 vertices at 64-1280 px);
- mixup and cutout: exact (mixup's Beta(32, 32) from a numpy RandomState
  seeded as JAX's global generator is);
- YoloDataset's host route through the Loader over two shuffled epochs,
  hyp.scratch-high, a copy with mosaic 0.5 and perspective 5e-4, and a
  detect-task copy with cutout 0.5: every key of every batch exact (masks
  within POLYGON_PIXEL_SHARE of an instance's pixels, 0 measured), both
  generators' states equal after.
"""

import json
import random

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import IMGSZ, ROOT, TRAIN_SHAPES, write_yolo_split
from yolo_dual_tpu.data import augment as jaug
from yolo_dual_tpu.data.dataset import create_dataloader as jax_create_dataloader
from yolo_dual_tpu.data.dataset import quad_collate as jax_quad_collate
from yolo_dual_tpu.ops import boxes as jboxes
from yolo_dual_tpu_torch.data import augment
from yolo_dual_tpu_torch.data.dataset import create_dataloader, quad_collate
from yolo_dual_tpu_torch.ops import boxes

cv2 = pytest.importorskip("cv2")

HYPS = ROOT / "yolo_dual_tpu" / "configs" / "hyps"
HIGH = yaml.safe_load((HYPS / "hyp.scratch-high.yaml").read_text())
FILL_SHARE = 2.02e-4  # of the pasted pixels: fill_poly against cv2.fillPoly (ROADMAP §C)
POLYGON_PIXEL_SHARE = 0.0  # of an instance's pixels at mask_ratio 4, as measured here
SEED = 5  # the loaders' seed: mixup (p 0.1) fires in each case's two epochs


@pytest.mark.parametrize("name", ["hyp.scratch-med", "hyp.scratch-high", "hyp.VOC",
                                  "hyp.Objects365"])
def test_hyp_json_equals_the_yaml(name):
    got = json.loads((ROOT / "yolo_dual_tpu_torch" / "configs" / "hyps" / f"{name}.json").read_text())
    assert got == yaml.safe_load((HYPS / f"{name}.yaml").read_text())


def test_rgb_to_hsv_equals_cv2_on_every_colour():
    c = np.arange(256)
    rgb = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(augment.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 31, 601])
def test_hsv_to_rgb_equals_cv2_on_every_value(width):
    """Rows of 256 pixels are all SIMD blocks, rows of 31 all scalar tail,
    rows of 601 both."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    hsv = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
    np.testing.assert_array_equal(augment.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_augment_hsv_matches_jax():
    rng = np.random.default_rng(0)
    for t in range(12):
        h, w = rng.integers(20, 300, 2)
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        rj, rp = random.Random(t), random.Random(t)
        want = jaug.augment_hsv(im.copy(), HIGH["hsv_h"], HIGH["hsv_s"], HIGH["hsv_v"], rng=rj)
        got = augment.augment_hsv(im.copy(), HIGH["hsv_h"], HIGH["hsv_s"], HIGH["hsv_v"], rng=rp)
        np.testing.assert_array_equal(got, want)
        assert rj.getstate() == rp.getstate()


def test_warp_perspective_equals_cv2():
    rng = np.random.default_rng(1)
    for t, s in enumerate((100, 74, 64, 130, 320)):
        im = rng.integers(0, 256, (2 * s, 2 * s, 3) if t % 2 == 0 else (2 * s, 2 * s),
                          dtype=np.uint8)
        M, _, wh = augment.sample_perspective_matrix(
            (2 * s, 2 * s), degrees=10, translate=0.1, scale=0.5, shear=5, perspective=5e-4,
            border=(-s // 2, -s // 2), rng=random.Random(t))
        np.testing.assert_array_equal(augment.warp_perspective_u8(im, M, wh, border=114),
                                      cv2.warpPerspective(im, M, dsize=wh, borderValue=(114,) * 3))


def _labels_and_polygons(rng, s, n, vertices=12):
    segs = [(rng.uniform(0.1, 0.9, 2) * s + rng.uniform(-0.1, 0.1, (vertices, 2)) * s
             ).astype(np.float32) for _ in range(n)]
    boxes = np.stack([np.r_[g.min(0), g.max(0)] for g in segs])
    return np.concatenate([rng.integers(0, 3, (n, 1)), boxes], 1).astype(np.float32), segs


@pytest.mark.parametrize("perspective", [0.0, 5e-4])
def test_random_perspective_matches_jax(perspective):
    rng = np.random.default_rng(2)
    for t in range(6):
        s = int(rng.integers(30, 160))
        im = rng.integers(0, 256, (2 * s, 2 * s, 3), dtype=np.uint8)
        labels, segs = _labels_and_polygons(rng, 2 * s, 3)
        kw = dict(degrees=10, translate=0.1, scale=0.5, shear=5, perspective=perspective,
                  border=(-s // 2, -s // 2))
        rj, rp = random.Random(t), random.Random(t)
        want = jaug.random_perspective(im.copy(), labels.copy(), [g.copy() for g in segs],
                                       rng=rj, **kw)
        got = augment.random_perspective(im.copy(), labels.copy(), [g.copy() for g in segs],
                                         rng=rp, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
        assert rj.getstate() == rp.getstate()


def test_copy_paste_matches_jax():
    """Labels and polygons exact; the pasted pixels within FILL_SHARE; then
    drawContours(FILLED) against cv2.fillPoly and fill_poly on the pasted
    polygons themselves."""
    rng = np.random.default_rng(3)
    off = pasted = 0
    for t in range(20):
        s = int(rng.integers(60, 400))
        im = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
        labels, segs = _labels_and_polygons(rng, s, int(rng.integers(1, 8)))
        rj, rp = random.Random(t), random.Random(t)
        want = jaug.copy_paste(im.copy(), labels.copy(), [g.copy() for g in segs], p=0.5, rng=rj)
        got = augment.copy_paste(im.copy(), labels.copy(), [g.copy() for g in segs], p=0.5,
                                 rng=rp)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype and len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
        assert rj.getstate() == rp.getstate()
        off += (got[0] != want[0]).any(-1).sum()
        pasted += (want[0] != im).any(-1).sum()
        for g in segs:
            pts = g.astype(np.int32)
            drawn = np.zeros((s, s, 3), np.uint8)
            cv2.drawContours(drawn, [pts], -1, (1, 1, 1), cv2.FILLED)
            filled = cv2.fillPoly(np.zeros((s, s), np.uint8), [pts], 1)
            np.testing.assert_array_equal(drawn[..., 0], filled)
            ours = augment.fill_poly(np.zeros((s, s), np.uint8), pts, 1)
            assert (ours != filled).sum() <= FILL_SHARE * max(filled.sum(), 1)
    assert pasted > 1000 and off <= FILL_SHARE * pasted, (off, pasted)


def test_mixup_and_cutout_match_jax():
    rng = np.random.default_rng(4)
    im1, im2 = (rng.integers(0, 256, (50, 60, 3), dtype=np.uint8) for _ in range(2))
    l1, l2 = np.zeros((1, 5), np.float32), np.ones((2, 5), np.float32)
    np.random.seed(5)
    want = jaug.mixup(im1, l1, [np.zeros((3, 2))], im2, l2, [np.ones((4, 2))])
    got = augment.mixup(im1, l1, [np.zeros((3, 2))], im2, l2, [np.ones((4, 2))],
                        rng=np.random.RandomState(5))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [g.shape for g in got[2]] == [g.shape for g in want[2]] == [(3, 2), (4, 2)]
    for t in range(20):
        im = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
        lab = np.concatenate([rng.integers(0, 3, (5, 1)), rng.uniform(0.1, 0.9, (5, 2)),
                              rng.uniform(0.05, 0.3, (5, 2))], 1).astype(np.float32)
        rj, rp = random.Random(t), random.Random(t)
        want = jaug.cutout(im.copy(), lab.copy(), 0.5, rng=rj)
        got = augment.cutout(im.copy(), lab.copy(), 0.5, rng=rp)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert rj.getstate() == rp.getstate()


def test_albumentations_adapter_is_a_no_op_without_the_package():
    try:  # installed neither here nor on the card
        import albumentations  # noqa: F401
        pytest.skip("albumentations is installed")
    except ImportError:
        pass
    im, lab = np.zeros((8, 8, 3), np.uint8), np.ones((2, 5), np.float32)
    r = random.Random(0)
    got_im, got_lab = augment.Albumentations(64)(im, lab, rng=r)
    assert got_im is im and got_lab is lab and r.getstate() == random.Random(0).getstate()
    assert jaug.Albumentations(64).transform is None


def test_box_functions_match_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    xyxy = np.sort(rng.uniform(0, 100, (7, 2, 2)), 1).reshape(7, 4).astype(np.float32)
    xyxy2 = np.sort(rng.uniform(0, 100, (5, 2, 2)), 1).reshape(5, 4).astype(np.float32)
    wh1, wh2 = rng.uniform(1, 50, (6, 2)).astype(np.float32), rng.uniform(1, 50, (4, 2)).astype(
        np.float32)
    t = torch.from_numpy
    for got, want in ((boxes.xyxy2xywh(t(xyxy)), jboxes.xyxy2xywh(xyxy)),
                      (boxes.xywhn2xyxy(t(x), 64, 48, 3, 5), jboxes.xywhn2xyxy(x, 64, 48, 3, 5)),
                      (boxes.xyxy2xywhn(t(xyxy), 90, 80, clip=True, eps=1e-3),
                       jboxes.xyxy2xywhn(xyxy, 90, 80, clip=True, eps=1e-3)),
                      (boxes.wh_iou(t(wh1), t(wh2)), jboxes.wh_iou(wh1, wh2)),
                      (boxes.bbox_ioa(t(xyxy), t(xyxy2)), jboxes.bbox_ioa(xyxy, xyxy2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert tuple(got.shape) == np.asarray(want).shape


KEYS = ("image", "targets", "tmask", "shape0", "ratio_pad", "index", "n_valid")
HOST_HYPS = {"scratch-high": (HIGH, "segment"),
             "mosaic0.5-perspective": (dict(HIGH, mosaic=0.5, perspective=5e-4), "segment"),
             "detect-cutout": (dict(HIGH, cutout=0.5), "detect")}


def _assert_masks_close(got, want, n):
    got = got[:, None] == np.arange(1, n + 1)[:, None, None]
    want = want[:, None] == np.arange(1, n + 1)[:, None, None]
    area = want.sum((-1, -2))
    share = (got != want).sum((-1, -2))[area > 0] / area[area > 0]
    assert share.max(initial=0) <= POLYGON_PIXEL_SHARE, share.max()
    assert not got[area == 0].any()


@pytest.mark.parametrize("name", list(HOST_HYPS))
def test_host_route_batches_match_jax(tmp_path, name):
    """YoloDataset(augment=True) on the host route through the Loader against
    JAX's, both asked for the device route (which falls back), every batch of
    two shuffled epochs; JAX's mixup draws from numpy's global generator,
    seeded as init_seeds seeds it."""
    hyp, task = HOST_HYPS[name]
    write_yolo_split(tmp_path, "train", 10, TRAIN_SHAPES, seed=4)
    seg = task == "segment"
    kw = dict(hyp=hyp, augment=True, shuffle=True, mask_downsample_ratio=4 if seg else 0,
              overlap_mask=seg, seed=SEED, task=task, device_aug=True)
    jl, _ = jax_create_dataloader(str(tmp_path / "jax" / "images" / "train"), IMGSZ, 4, **kw)
    jl.num_shards, jl.shard_index = 1, 0
    pl, pds = create_dataloader(str(tmp_path / "port" / "images" / "train"), IMGSZ, 4, **kw)
    assert not pds.device_aug and not jl.dataset.device_aug
    np.random.seed(SEED)
    fresh = np.random.RandomState(SEED).get_state()[1]
    kept = 0
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == 3
        for want, got in zip(jb, pb):
            assert set(got) == set(want) == set(KEYS) | ({"masks"} if seg else set())
            for k in KEYS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].dtype == want[k].dtype, k
            if seg:
                assert got["masks"].shape == want["masks"].shape
                _assert_masks_close(got["masks"], want["masks"], pds.max_labels)
            kept += int(want["tmask"].sum())
        assert pds.rng.getstate() == jl.dataset.rng.getstate()
        np.testing.assert_array_equal(pds.np_rng.get_state()[1], np.random.get_state()[1])
    mixed = not np.array_equal(pds.np_rng.get_state()[1], fresh)
    assert mixed and kept, "mixup drew no ratio or no sample kept a label"


def test_quad_collate_matches_jax(tmp_path):
    """Detect samples of the host letterbox through quad_collate: the
    enlarged frame (INTER_LINEAR) and the 2x2 mosaic, and the Loader's
    n_valid of a padded last quad; samples with masks are refused."""
    write_yolo_split(tmp_path, "val", 7, TRAIN_SHAPES, seed=6)
    kw = dict(augment=False, mask_downsample_ratio=0, overlap_mask=False, task="detect")
    jl, _ = jax_create_dataloader(str(tmp_path / "jax" / "images" / "val"), IMGSZ, 8, **kw)
    jl.num_shards, jl.shard_index = 1, 0
    jl.collate = jax_quad_collate
    pl, _ = create_dataloader(str(tmp_path / "port" / "images" / "val"), IMGSZ, 8,
                              collate=quad_collate, **kw)
    (want,), (got,) = list(jl), list(pl)
    assert got["image"].shape == (2, 2 * IMGSZ, 2 * IMGSZ, 3) and int(got["n_valid"]) == 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    seg_ds = create_dataloader(str(tmp_path / "port" / "images" / "val"), IMGSZ, 4,
                               mask_downsample_ratio=4)[1]
    with pytest.raises(ValueError, match="detection samples only"):
        quad_collate([seg_ds[i] for i in range(4)])
