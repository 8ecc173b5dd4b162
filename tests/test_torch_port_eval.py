"""The evaluation slice against the JAX package on identical numpy inputs:
the NMS tie order and its multi-label branch, mask IoU, the AP accumulators,
the TP matching and `evaluate_segment` end to end, on a small model (the
TINY_SEG net of tests/test_eval_dp.py: 64 px, nc 3, nm 4).

Tolerances: the matches are booleans and must be equal; AP and metric floats
1e-6 (float64 host numpy on the same inputs); NMS rows rtol 1e-6, atol 1e-5,
as tests/test_torch_port_ops.py (XLA's and torch's sigmoids differ in the
last bits, scaled into box coordinates of up to a few hundred px); the
validator's 8 metrics and per-class maps 1e-4 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import IMGSZ, TINY_NC, TINY_NM, port_model, primed_tiny
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu.metrics import Metrics as JaxMetrics
from yolo_dual_tpu.metrics import ap_per_class as jax_ap_per_class
from yolo_dual_tpu.metrics import ap_per_class_box_and_mask as jax_ap_box_mask
from yolo_dual_tpu.metrics.seg import match_predictions_device as jax_match_device
from yolo_dual_tpu.ops import mask_ops as jax_mask_ops
from yolo_dual_tpu.ops.nms import nms_from_raw as jax_nms_from_raw
from yolo_dual_tpu_torch.engine.validator import evaluate_segment
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.metrics import (Metrics, ap_per_class, ap_per_class_box_and_mask,
                                         match_predictions, match_predictions_device)
from yolo_dual_tpu_torch.ops import mask_ops
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.parallel import make_mesh

ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
STRIDES = (8, 16, 32)
NC, NM = 80, 32



def tied_maps(seed, bs=2, imgsz=320):
    """Raw head maps with N(0, 1) logits, but in half the cells objectness
    and class 0 at logit 30: ~3,150 candidates tie at conf 1.0 (320 px)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in STRIDES:
        r = rng.normal(0, 1, (bs, 3, imgsz // s, imgsz // s, 5 + NC + NM)).astype(np.float32)
        hot = rng.uniform(size=r.shape[:4]) < 0.5
        r[..., 4][hot] = 30
        r[..., 5][hot] = 30
        out.append(r)
    return out


def assert_nms_equal(raw, **kw):
    want, want_n = jax_nms_from_raw([jnp.asarray(r) for r in raw], ANCHORS, STRIDES, nm=NM, **kw)
    got, got_n = nms_from_raw([torch.from_numpy(r) for r in raw], ANCHORS, STRIDES, nm=NM, **kw)
    want, want_n = np.asarray(want), np.asarray(want_n)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    for i, n in enumerate(want_n):
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], rtol=1e-6, atol=1e-5)
        assert not got[i, n:].any()
    return want_n


@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("max_det,topk", [(300, 1024), (50, 128)])
def test_nms_from_raw_breaks_ties_as_jax(multi_label, max_det, topk):
    """C1: with thousands of candidates tied at conf 1.0 the port keeps the
    same rows, in the same order, as JAX (lax.top_k's lower-index-first)."""
    n = assert_nms_equal(tied_maps(0), conf_thres=0.25, iou_thres=0.45, max_det=max_det,
                         pre_nms_topk=topk, multi_label=multi_label)
    assert (n == max_det).all()


@pytest.mark.parametrize("topk", [4096, 200])
def test_nms_from_raw_multi_label_matches_jax(topk):
    """The validator's branch on untied N(0, 1) logits: every (candidate,
    class) above conf 0.001 competes; 4096 (the validator's) and a cut."""
    rng = np.random.default_rng(topk)
    raw = [rng.normal(0, 1, (2, 3, 128 // s, 128 // s, 5 + NC + NM)).astype(np.float32)
           for s in STRIDES]
    n = assert_nms_equal(raw, conf_thres=0.001, iou_thres=0.6, max_det=300, pre_nms_topk=topk,
                         multi_label=True)
    assert n.min() > 50


def test_mask_iou_matches_jax():
    rng = np.random.default_rng(1)
    a = (rng.uniform(size=(5, 256)) < 0.4).astype(np.float32)
    b = (rng.uniform(size=(7, 256)) < 0.6).astype(np.float32)
    np.testing.assert_allclose(mask_ops.mask_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_mask_ops.mask_iou(a, b)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        mask_ops.masks_iou(torch.from_numpy(a), torch.from_numpy(b[:5])).numpy(),
        np.asarray(jax_mask_ops.masks_iou(a, b[:5])), rtol=0, atol=1e-6)


def seeded_stats(seed, n=400, nt=120, nc=5):
    rng = np.random.default_rng(seed)
    tp_b = rng.uniform(size=(n, 10)) < np.linspace(0.7, 0.2, 10)
    tp_m = tp_b & (rng.uniform(size=(n, 10)) < 0.8)
    conf = rng.uniform(size=n).astype(np.float32)
    return tp_b, tp_m, conf, rng.integers(0, nc, n).astype(np.float32), \
        rng.integers(0, nc - 1, nt).astype(np.float32)


def test_ap_per_class_matches_jax():
    tp_b, _, conf, pred_cls, target_cls = seeded_stats(2)
    for got, want in zip(ap_per_class(tp_b, conf, pred_cls, target_cls),
                         jax_ap_per_class(tp_b, conf, pred_cls, target_cls)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ap_box_and_mask_and_metrics_match_jax():
    stats = seeded_stats(3)
    got, want = ap_per_class_box_and_mask(*stats), jax_ap_box_mask(*stats)
    for kind in ("boxes", "masks"):
        for key in want[kind]:
            np.testing.assert_allclose(got[kind][key], want[kind][key], rtol=0, atol=1e-6)
    m, jm = Metrics(), JaxMetrics()
    m.update(got)
    jm.update(want)
    np.testing.assert_allclose(m.mean_results(), jm.mean_results(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.get_maps(5), jm.get_maps(5), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.class_result(1), jm.class_result(1), rtol=0, atol=1e-6)
    assert list(m.ap_class_index) == list(jm.ap_class_index)


def seeded_matching(seed, bs=3, m=6, d=20):
    """IoUs on a 0.05 grid (exact in float32, and ties between gts, as real
    dets overlapping two gts equally), classes from 2, some pairs masked."""
    rng = np.random.default_rng(seed)
    iou = (rng.integers(0, 21, (bs, m, d)) * 0.05).astype(np.float32)
    iou *= rng.uniform(size=(bs, m, d)) < 0.5
    return (rng.integers(0, 2, (bs, d)).astype(np.float32),
            rng.integers(0, 2, (bs, m)).astype(np.float32), iou)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_device_matches_jax(seed):
    pred_cls, gt_cls, iou = seeded_matching(seed)
    got = match_predictions_device(torch.from_numpy(pred_cls), torch.from_numpy(gt_cls),
                                   torch.from_numpy(iou)).numpy()
    assert got.shape == (3, 20, 10) and got.dtype == bool and got.any() and not got.all()
    for b in range(3):
        want = np.asarray(jax_match_device(jnp.asarray(pred_cls[b]), jnp.asarray(gt_cls[b]),
                                           jnp.asarray(iou[b])))
        np.testing.assert_array_equal(got[b], want)


def test_match_predictions_device_matches_numpy_without_ties():
    """The reference's numpy rule, on IoUs without ties (with them, its
    sort picks among equal pairs in an order of its own)."""
    rng = np.random.default_rng(5)
    iou = rng.uniform(size=(8, 40)).astype(np.float32) * (rng.uniform(size=(8, 40)) < 0.5)
    pred_cls = rng.integers(0, 3, 40).astype(np.float32)
    gt_cls = rng.integers(0, 3, 8).astype(np.float32)
    got = match_predictions_device(torch.from_numpy(pred_cls), torch.from_numpy(gt_cls),
                                   torch.from_numpy(iou)).numpy()
    np.testing.assert_array_equal(got, match_predictions(pred_cls, gt_cls, iou))


# -- evaluate_segment end to end ---------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return primed_tiny()


def self_labelled_batches(v, overlap: bool, raw: bool, n_batches=2, bs=4, max_labels=6):
    """Batches in the JAX loader's format whose gt is the primed model's own
    top predictions (boxes wider and taller than 2 px, up to 4 an image) and
    their masks, so box and mask TPs exist. raw=True: 48 x 64 `image_raw`
    frames, letterboxed to 64 (scaleup=False) for the labels."""
    rng = np.random.default_rng(7 + overlap + 2 * raw)
    model = port_model(v).eval()
    batches = []
    for _ in range(n_batches):
        h = 48 if raw else IMGSZ
        yy, xx = np.mgrid[0:h, 0:IMGSZ]
        frames = np.stack([np.clip((127 + 100 * np.sin(xx / rng.uniform(3, 9) + rng.uniform(0, 6))
                                    * np.cos(yy / rng.uniform(3, 9)))[..., None]
                                   + rng.normal(0, 20, (h, IMGSZ, 3)), 0, 255)
                           for _ in range(bs)]).astype(np.uint8)
        x = letterbox_normalize(torch.from_numpy(frames), IMGSZ, scaleup=False) if raw else \
            torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255
        with torch.no_grad():
            levels, protos = model(x, decode=False)
            head = model.model[-1]
            out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=1e-4,
                                   iou_thres=0.6, max_det=50, nm=TINY_NM)
        targets = np.zeros((bs, max_labels, 5), np.float32)
        tmask = np.zeros((bs, max_labels), bool)
        m = IMGSZ // 4
        masks = np.zeros((bs, m, m) if overlap else (bs, max_labels, m, m), np.float32)
        for b in range(bs):
            d = out[b, :int(nv[b])]
            d = d[((d[:, 2] - d[:, 0]) > 2) & ((d[:, 3] - d[:, 1]) > 2)][:4]
            pm = mask_ops.process_mask(protos[b], d[:, 6:], d[:, :4], (IMGSZ, IMGSZ)).numpy()
            for j, dd in enumerate(d.numpy()):
                x1, y1, x2, y2 = np.clip(dd[:4], 0, IMGSZ)
                targets[b, j] = [dd[5], (x1 + x2) / 2 / IMGSZ, (y1 + y2) / 2 / IMGSZ,
                                 (x2 - x1) / IMGSZ, (y2 - y1) / IMGSZ]
                tmask[b, j] = True
                if overlap:
                    masks[b][pm[j]] = j + 1
                else:
                    masks[b, j] = pm[j]
        batch = {"targets": targets, "tmask": tmask, "masks": masks, "n_valid": np.int32(bs)}
        batch["image_raw" if raw else "image"] = frames
        batches.append(batch)
    batches[-1]["n_valid"] = np.int32(bs - 1)  # a padded final batch
    return batches


class BatchLoader:
    """In-memory batches with the `dataset.imgsz` the image_raw route reads."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = type("DS", (), {"imgsz": IMGSZ, "im_files": None})()

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("raw", [False, True], ids=["image", "image_raw"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "instance"])
def test_evaluate_segment_matches_jax(tiny, raw, overlap):
    jm, v = tiny
    loader = BatchLoader(self_labelled_batches(v, overlap, raw))
    kw = dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM)
    want, want_maps, _ = jax_evaluate_segment(jm, v, loader, TINY_NC, **kw)
    got, got_maps, times = evaluate_segment(port_model(v), loader, TINY_NC, device="cpu", **kw)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05 and got[6] > 0.05, got  # mAP50 of boxes and of masks
    assert len(times) == 3 and all(t > 0 for t in times)


@pytest.mark.parametrize("option", ["plots", "mesh"])
def test_evaluate_segment_refuses_what_is_not_ported(tiny, option, tmp_path):
    """Both are ported: `plots` draws the boxes' and masks' PR, F1, P and R
    curves (the metrics unchanged); a one-rank mesh gives the one-process
    metrics (tests/test_torch_port_dist.py holds two ranks against JAX)."""
    loader = BatchLoader(self_labelled_batches(tiny[1], True, False))
    kw = dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM, device="cpu")
    want, want_maps, _ = evaluate_segment(port_model(tiny[1]), loader, TINY_NC, **kw)
    extra = {"plots": True, "save_dir": str(tmp_path)} if option == "plots" else \
        {"mesh": make_mesh(device="cpu")}
    got, got_maps, _ = evaluate_segment(port_model(tiny[1]), loader, TINY_NC, **kw, **extra)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(got_maps, want_maps)
    assert len(list(tmp_path.glob("*_curve.png"))) == (8 if option == "plots" else 0)


# Flipped mask pixels allowed between the port's predictions.json and JAX's, as a
# share of the masks' pixels: a proto-resolution value within float32 rounding of
# 0.5 flips a whole upsampled cell, a final value within cv2's Intel IPP gap
# (tests/test_torch_port_predict_io.py) one pixel.
JSON_FLIP_SHARE = 1e-3


def test_evaluate_segment_save_json_matches_jax(tiny, tmp_path):
    """evaluate_segment(save_json=True) on letterboxed frames whose original
    shapes (`shape0`) make the masks really resized: JAX's entries, bbox
    within 1e-3 px (plus JSON's 3-decimal rounding), scores within 1e-5,
    the RLE masks equal but for counted flips, at most JSON_FLIP_SHARE of
    their pixels; category ids through a class map."""
    import json

    from yolo_dual_tpu.utils.coco import coco80_to_coco91_class
    from yolo_dual_tpu_torch.utils.coco import rle_to_binary_mask
    jm, v = tiny
    batches = self_labelled_batches(v, overlap=True, raw=False)
    shapes0 = [(96, 128), (48, 64), (72, 96), (50, 66)]
    k = 0
    for b in batches:
        n = len(b["image"])
        b["index"] = np.arange(k, k + n)
        b["shape0"] = np.array([shapes0[i % 4] for i in range(k, k + n)], np.int32)
        k += n
    loader = BatchLoader(batches)
    loader.dataset.im_files = [f"{100 + i}.jpg" for i in range(k)]
    kw = dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM, max_det=40, save_json=True,
              class_map=coco80_to_coco91_class())
    jax_evaluate_segment(jm, v, loader, TINY_NC, save_dir=str(tmp_path / "jax"), **kw)
    evaluate_segment(port_model(v), loader, TINY_NC, device="cpu", save_dir=str(tmp_path / "port"),
                     **kw)
    want = json.loads((tmp_path / "jax" / "predictions.json").read_text())
    got = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert len(got) == len(want) > 20
    assert {e["category_id"] for e in got} <= {1, 2, 3}
    flips = pixels = same = 0
    by_image = {}
    for g in got:
        by_image.setdefault(g["image_id"], []).append(g)
    for w in want:
        pool = by_image[w["image_id"]]
        hit = [j for j, g in enumerate(pool) if g["category_id"] == w["category_id"]
               and abs(g["score"] - w["score"]) <= 2e-5
               and np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= 2e-3]
        assert hit, w
        g = pool.pop(hit[0])
        assert g["segmentation"]["size"] == w["segmentation"]["size"] \
            == list(shapes0[(w["image_id"] - 100) % 4])
        gm, wm = rle_to_binary_mask(g["segmentation"]), rle_to_binary_mask(w["segmentation"])
        flips += int((gm != wm).sum())
        pixels += gm.size
        same += g["segmentation"]["counts"] == w["segmentation"]["counts"]
    print(f"save_json: {len(want)} entries, {same} RLE strings equal, {flips} of {pixels} "
          "mask pixels flipped")
    assert flips <= JSON_FLIP_SHARE * pixels, (flips, pixels)
    assert same >= 0.9 * len(want)
