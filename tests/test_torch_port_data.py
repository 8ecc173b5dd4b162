"""The validation data path against the JAX package: the polygon rasteriser
against cv2, the port's `.npy` YoloDataset(device_preprocess=True) and Loader
against JAX's on the same frames (PNG for JAX, the same pixels as `.npy` for
the port), and the segment.val CLI end to end on the CPU against JAX's
evaluate_segment on JAX's loader.

Tolerances: everything the loader emits is exact, the masks too when every
polygon is an axis-aligned rectangle with integer vertices. On other polygons
OpenCV's fill and the port's may differ in edge pixels. Measured (and held,
ROADMAP.md §C): on random star polygons at 64 px, partly outside the plane,
0.0202% of the filled pixels differ at full resolution; after the 4x
downsampling of the instance masks no pixel differs, on 200 polygons at 640
px nor in the datasets here. The CLI's metrics: 1e-4.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_common import IMGSZ, TINY_NC, TINY_NM, TINY_SEG, port_model, primed_tiny
from yolo_dual_tpu.data.augment import polygon2mask as jax_polygon2mask
from yolo_dual_tpu.data.dataset import YoloDataset as JaxYoloDataset
from yolo_dual_tpu.data.loader import Loader as JaxLoader
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu_torch.data import augment
from yolo_dual_tpu_torch.data.dataset import YoloDataset
from yolo_dual_tpu_torch.data.loader import Loader
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.segment import val as val_cli

cv2 = pytest.importorskip("cv2")

POLYGON_PIXEL_SHARE = 0.0  # of an instance's pixels at mask_ratio 4, as measured
H0, W0 = 48, 64  # the frames' raw shape: letterboxed to 64 with 8-px bands top and bottom


def random_polygon(rng, w, h):
    """A star-shaped polygon of 3-11 vertices around a random centre."""
    n = rng.integers(3, 12)
    c = rng.uniform(0, [w, h])
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(2, max(w, h) / 2) * rng.uniform(0.4, 1.0, n)
    return np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1)


def test_fill_poly_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(500):  # rectangles: exact
        x1, x2 = sorted(rng.integers(-3, 67, 2))
        y1, y2 = sorted(rng.integers(-3, 67, 2))
        poly = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.int32)
        want = cv2.fillPoly(np.zeros((64, 64), np.uint8), [poly], 1)
        np.testing.assert_array_equal(augment.fill_poly(np.zeros((64, 64), np.uint8), poly), want)
    differ = total = 0
    for _ in range(1000):
        poly = random_polygon(rng, 64, 64).astype(np.int32)
        want = cv2.fillPoly(np.zeros((64, 64), np.uint8), [poly], 1)
        got = augment.fill_poly(np.zeros((64, 64), np.uint8), poly)
        differ += (got != want).sum()
        total += want.sum()
    assert differ / total < 2.1e-4, differ / total  # measured 2.02e-4 (54 of 267,172)


@pytest.mark.parametrize("ratio", [1, 2, 3, 4, 8])
def test_resize_linear_matches_cv2(ratio):
    rng = np.random.default_rng(ratio)
    for _ in range(20):
        h, w = rng.integers(8, 100, 2) * 4
        m = ((rng.uniform(size=(h, w)) < 0.5) * rng.integers(1, 255)).astype(np.uint8)
        np.testing.assert_array_equal(augment.resize_linear_u8(m, h // ratio, w // ratio),
                                      cv2.resize(m, (w // ratio, h // ratio)))


def test_polygon2mask_matches_cv2_per_instance():
    """The downsampled (mask_ratio 4) instance masks of JAX's polygon2mask
    (cv2.fillPoly + cv2.resize) and the port's, on a 640-px plane."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(200):
        poly = random_polygon(rng, 640, 640).clip(0, 640).reshape(-1)
        want = jax_polygon2mask((640, 640), [poly], 1, 4)
        got = augment.polygon2mask((640, 640), [poly], 1, 4)
        if want.sum():
            worst = max(worst, (got != want).sum() / want.sum())
    assert worst <= POLYGON_PIXEL_SHARE, worst


def write_dataset(root, n=5, rects=True, seed=0):
    """n frames of H0 x W0 under root/{jax,port}/images (PNG and .npy of the
    same pixels) and the same polygon labels under each labels/: 1-4 objects
    a frame of 3 classes, rectangles with integer pixel vertices or random
    polygons; frame 2 has no label file, frame 3 an empty one."""
    rng = np.random.default_rng(seed)
    for side in ("jax", "port"):
        (root / side / "images").mkdir(parents=True)
        (root / side / "labels").mkdir(parents=True)
    for i in range(n):
        im = rng.integers(0, 256, (H0, W0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "jax" / "images" / f"im{i}.png"), im[..., ::-1])
        np.save(root / "port" / "images" / f"im{i}.npy", im)
        if i == 2:
            continue
        lines = []
        for _ in range(0 if i == 3 else rng.integers(1, 5)):
            if rects:
                x1, x2 = sorted(rng.choice(W0 + 1, 2, replace=False))
                y1, y2 = sorted(rng.choice(H0 + 1, 2, replace=False))
                poly = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float64)
            else:
                poly = random_polygon(rng, W0, H0).clip(0, [W0, H0])
            xy = (poly / [W0, H0]).reshape(-1)
            lines.append(" ".join([str(rng.integers(0, TINY_NC))] + [f"{v:.6f}" for v in xy]))
        for side in ("jax", "port"):
            (root / side / "labels" / f"im{i}.txt").write_text("\n".join(lines))
    return root


def relabel_with_model(root, v):
    """Every frame's labels under root/{jax,port}: the primed TINY_SEG `v`'s
    own boxes (up to 4 a frame) as rectangles, so both metric halves of a
    validation are non-zero."""
    model = port_model(v).eval()
    for f in sorted((root / "port" / "images").glob("*.npy")):
        x = letterbox_normalize(torch.from_numpy(np.load(f))[None], IMGSZ, scaleup=False)
        with torch.no_grad():
            levels, _ = model(x, decode=False)
            out, nv = nms_from_raw(levels, model.model[-1].anchors, model.model[-1].strides,
                                   conf_thres=1e-4, iou_thres=0.6, max_det=20, nm=TINY_NM)
        lines = []
        for d in out[0, :int(nv[0])].numpy()[:4]:
            x1, x2 = np.clip(np.round(d[[0, 2]]), 0, IMGSZ) / IMGSZ
            y1, y2 = (np.clip(np.round(d[[1, 3]]), 8, 56) - 8) / H0
            if x2 - x1 > 2 / IMGSZ and y2 - y1 > 2 / H0:
                lines.append(f"{int(d[5])} {x1} {y1} {x2} {y1} {x2} {y2} {x1} {y2}")
        for side in ("jax", "port"):
            (root / side / "labels" / f"{f.stem}.txt").write_text("\n".join(lines))


def loaders(root, overlap=True, bs=2, shuffle=False):
    kw = dict(imgsz=IMGSZ, mask_ratio=4, overlap=overlap, max_labels=6)
    jds = JaxYoloDataset(str(root / "jax" / "images"), task="segment", device_preprocess=True, **kw)
    pds = YoloDataset(str(root / "port" / "images"), device_preprocess=True, **kw)
    return (JaxLoader(jds, batch_size=bs, shuffle=shuffle, seed=3, num_shards=1, shard_index=0),
            Loader(pds, batch_size=bs, shuffle=shuffle, seed=3))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "instance"])
@pytest.mark.parametrize("rects", [True, False], ids=["rectangles", "polygons"])
def test_dataset_and_loader_match_jax(tmp_path, overlap, rects):
    jl, pl = loaders(write_dataset(tmp_path, rects=rects, seed=int(rects)), overlap)
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == len(pl) == 3
    for want, got in zip(jb, pb):
        assert set(got) == set(want)
        for key in ("image_raw", "targets", "tmask", "shape0", "ratio_pad", "index", "n_valid"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype, key
        if rects:
            np.testing.assert_array_equal(got["masks"], want["masks"])
        else:
            inst = (lambda m: m[:, None] == np.arange(1, 7)[:, None, None]) if overlap else \
                (lambda m: m > 0)
            g, w = inst(got["masks"]), inst(want["masks"])
            area = w.sum((-1, -2))
            share = (g != w).sum((-1, -2))[area > 0] / area[area > 0]
            assert share.max(initial=0) <= POLYGON_PIXEL_SHARE
    assert pb[-1]["n_valid"] == 1 and pb[0]["tmask"].any()
    assert pb[0]["image_raw"].shape == (2, H0, W0, 3) and pb[0]["shape0"].tolist() == [[H0, W0]] * 2


def test_loader_shuffles_as_jax(tmp_path):
    jl, pl = loaders(write_dataset(tmp_path, n=7), shuffle=True)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jidx = [b["index"].tolist() for b in jl]
        assert [b["index"].tolist() for b in pl] == jidx
    assert jidx != [[0, 1], [2, 3], [4, 5], [6, 6]]


def test_dataset_refuses_what_is_not_ported(tmp_path):
    """Training on the host pixel route (device_aug=False) builds, and a hyp
    the device route cannot run (mixup, copy_paste) falls back to it as JAX
    does (data/dataset.py:141-148); device_preprocess still refuses frames of
    more than one shape."""
    write_dataset(tmp_path)
    hyp = dict(mosaic=1.0)
    for kw, device_aug in ((dict(augment=True, hyp=hyp), False),
                           (dict(augment=True, hyp=hyp, device_aug=True), True),
                           (dict(augment=True, hyp=dict(hyp, mixup=0.1), device_aug=True), False),
                           (dict(augment=True, hyp=dict(hyp, copy_paste=0.1), device_aug=True),
                            False)):
        ds = YoloDataset(str(tmp_path / "port" / "images"), **kw)
        assert ds.device_aug is device_aug
        assert ("aug_tiles" in ds[0]) is device_aug and ("image" in ds[0]) is not device_aug
    other = np.zeros((50, 60, 3), np.uint8)
    np.save(tmp_path / "port" / "images" / "odd.npy", other)
    with pytest.raises(ValueError, match="uniform raw image shape"):
        YoloDataset(str(tmp_path / "port" / "images"), device_preprocess=True)


def test_val_cli_matches_jax(tmp_path):
    """segment.val.run on the CPU: a data directory and a JSON data file, the
    reference-style .pt weights of the primed TINY model, bs 2 with a padded
    final batch, against JAX's evaluate_segment on JAX's loader of the PNGs;
    then with --augment and with --soft-nms."""
    jm, v = primed_tiny()
    root = write_dataset(tmp_path, n=5)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_SEG))
    weights = tmp_path / "tiny.pt"
    torch.save(state_dict_from_flax(v), weights)
    relabel_with_model(root, v)
    jl, _ = loaders(root, bs=2)
    jl.dataset.max_labels = 120
    want, want_maps, _ = jax_evaluate_segment(jm, v, jl, TINY_NC, conf_thres=0.001,
                                              iou_thres=0.6, nm=TINY_NM)
    data_json = tmp_path / "data.json"
    data_json.write_text(json.dumps({"path": str(root / "port"), "val": "images", "nc": TINY_NC,
                                     "names": ["a", "b", "c"]}))
    kw = dict(weights=str(weights), cfg=str(cfg), batch_size=2, imgsz=IMGSZ, device="cpu",
              device_preprocess=True)
    for data in (root / "port", data_json):
        got, got_maps, times = val_cli.run(data=str(data), **kw)
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05 and got[6] > 0.05, got
    # the label export: detections (and with save_hybrid the gt rows at conf 1)
    # rescaled to the raw frames, as JAX writes them
    jl, _ = loaders(root, bs=2)
    jax_evaluate_segment(jm, v, jl, TINY_NC, conf_thres=0.001, iou_thres=0.6, nm=TINY_NM,
                         save_txt=True, save_conf=True, save_hybrid=True,
                         save_dir=str(tmp_path / "jax_txt"))
    val_cli.run(data=str(root / "port"), save_txt=True, save_conf=True, save_hybrid=True,
                project=str(tmp_path / "runs"), **kw)
    for i in range(5):
        want = np.loadtxt(tmp_path / "jax_txt" / "labels" / f"im{i}.txt", ndmin=2)
        got = np.loadtxt(tmp_path / "runs" / "exp" / "labels" / f"im{i}.txt", ndmin=2)
        assert got.shape == want.shape and want.shape[1] == 6 and len(want) > 4
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # --augment and --soft-nms (the latter at conf 0.25, where soft-NMS's decay cuts rows)
    for flag, jax_kw in (("augment", {"augment": True}),
                         ("soft_nms", {"use_soft_nms": True, "conf_thres": 0.25})):
        jl, _ = loaders(root, bs=2)
        jl.dataset.max_labels = 120
        want, want_maps, _ = jax_evaluate_segment(jm, v, jl, TINY_NC, **{
            "conf_thres": 0.001, "iou_thres": 0.6, "nm": TINY_NM, **jax_kw})
        got, got_maps, _ = val_cli.run(data=str(root / "port"), **{
            **kw, flag: True, "conf_thres": jax_kw.get("conf_thres", 0.001)})
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=1e-4, err_msg=flag)
        np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4, err_msg=flag)
    # --plots draws the curves into the run directory; --data-parallel in one
    # process (no torch.distributed.run) evaluates as without it
    got, got_maps, _ = val_cli.run(data=str(root / "port"), plots=True, data_parallel=True,
                                   project=str(tmp_path / "runs"), name="plots", **kw)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    assert sorted(p.name for p in (tmp_path / "runs" / "plots").glob("*.png")) == sorted(
        f"{k}{c}_curve.png" for k in ("Box", "Mask") for c in ("F1", "P", "PR", "R"))
    # --save-json: JAX's entries; a val path naming coco takes COCO's 91-id categories
    jl, _ = loaders(root, bs=2)
    jax_evaluate_segment(jm, v, jl, TINY_NC, conf_thres=0.001, iou_thres=0.6, nm=TINY_NM,
                         max_det=20, save_json=True, save_dir=str(tmp_path / "jax_json"))
    (tmp_path / "coco").symlink_to(root / "port", target_is_directory=True)
    coco_json = tmp_path / "coco.json"
    coco_json.write_text(json.dumps({"path": str(tmp_path / "coco"), "val": "images",
                                     "nc": TINY_NC}))
    entries = {}
    for name, data in (("plain", root / "port"), ("coco", coco_json)):
        val_cli.run(data=str(data), save_json=True, max_det=20, project=str(tmp_path / "json"),
                    name=name, **kw)
        entries[name] = json.loads((tmp_path / "json" / name / "predictions.json").read_text())
    want = json.loads((tmp_path / "jax_json" / "predictions.json").read_text())
    assert len(entries["plain"]) == len(entries["coco"]) == len(want) > 5
    key = lambda e: (str(e["image_id"]), -e["score"], e["bbox"])  # noqa: E731
    for g, c, w in zip(*(sorted(x, key=key) for x in (entries["plain"], entries["coco"], want))):
        assert g["image_id"] == w["image_id"] and g["category_id"] == w["category_id"]
        assert abs(g["score"] - w["score"]) <= 2e-5
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=2e-3)
        assert g["segmentation"] == w["segmentation"]
        assert c["category_id"] == [1, 2, 3][g["category_id"]]
    opt = val_cli.parse_opt(["--data", "d", "--device-preprocess", "--batch-size", "8"])
    assert opt.device_preprocess and opt.batch_size == 8 and opt.conf_thres == 0.001
