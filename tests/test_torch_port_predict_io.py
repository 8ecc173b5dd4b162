"""The prediction sources and outputs, the contour tracer and COCO JSON of
the port against the JAX package (and cv2) on the CPU.

- ops/contours.py against cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE) exactly, contour for contour in cv2's order, on ~200
  masks: lone pixels, diagonal-only contacts, holes and objects in holes,
  blobs touching each edge, thin lines, noise, empty masks; masks2segments
  against JAX's for both strategies.
- process_mask_upsample against JAX's (1e-5; binarised masks equal except
  within 1e-5 of 0.5); resize_linear_f32 against cv2's float32
  INTER_LINEAR: exact with OpenCV's own code (Intel IPP off), within 3e-6
  of IPP's; the validator's mask chain against JAX's cv2 chain, flips only
  where cv2's value lies within 3e-6 of 0.5.
- The COCO codec: JAX's tests/test_coco.py cases on the port's functions,
  the device-side RLE of torch masks, save_one_json and
  write_predictions_json giving JAX's JSON.
- The predictor on an mp4 written with cv2 (the primed TINY_SEG at 64 px,
  conf 0.25): JAX's per-frame detections and frame count, an mp4 out with
  as many frames, txt rows with the frame suffix, crops and feature-map
  files against JAX's; vid_stride and max_frames; a `.streams` file over
  the video; `screen` without mss; the `.npy` crops and maps without cv2 and
  matplotlib; --update, --data, --view-img; classify.predict on the video.
"""

import importlib.util
import json
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from detection_matching import pair_detections
from torch_port_common import IMGSZ, ROOT, TINY_NC, TINY_SEG, primed_tiny
from yolo_dual_tpu.data import streams as jax_streams
from yolo_dual_tpu.engine import predictor as jax_predictor
from yolo_dual_tpu.ops import mask_ops as jax_mask_ops
from yolo_dual_tpu.utils import coco as jax_coco
from yolo_dual_tpu_torch.data import streams
from yolo_dual_tpu_torch.engine import predictor
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.ops import mask_ops
from yolo_dual_tpu_torch.ops.contours import find_external_contours
from yolo_dual_tpu_torch.segment import predict as predict_cli
from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from yolo_dual_tpu_torch.utils import coco
from yolo_dual_tpu_torch.utils.plots import save_one_box

cv2 = pytest.importorskip("cv2")

IPP_GAP = 3e-6  # cv2's Intel IPP float32 resize against OpenCV's own arithmetic
N_VIDEO = 5
VIDEO_HW = (48, 64)
NAMES = {0: "ant", 1: "bee", 2: "cat"}


# ---------------------------------------------------------------------------
# contours and masks2segments
# ---------------------------------------------------------------------------

def contour_masks(kind: str, n: int = 30, seed: int = 0):
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    out = []
    for i in range(n):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        m = np.zeros((h, w), np.uint8)
        if kind == "pixels":
            for _ in range(rng.integers(1, 6)):
                m[rng.integers(0, h), rng.integers(0, w)] = 1
            m[0, 0] = m[-1, -1] = i % 2
        elif kind == "diagonal":
            for _ in range(rng.integers(1, 4)):
                y, x, s = rng.integers(0, h), rng.integers(0, w), rng.choice([-1, 1])
                for k in range(rng.integers(2, 12)):
                    if 0 <= y + k < h and 0 <= x + s * k < w:
                        m[y + k, x + s * k] = 1
            if i % 3 == 0:
                m[:] = 0
                m[::2, ::2] = 1
                m[1::2, 1::2] = 1
        elif kind == "holes":
            h, w = int(rng.integers(12, 40)), int(rng.integers(12, 40))
            m = np.zeros((h, w), np.uint8)
            for _ in range(rng.integers(1, 4)):
                cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
                r = int(rng.integers(3, 12))
                cv2.circle(m, (cx, cy), r, 1, -1)
                cv2.circle(m, (cx, cy), r // 2, 0, -1)
                if r > 6:
                    cv2.circle(m, (cx, cy), r // 5, 1, -1)   # an object in the hole
            if i % 4 == 0:
                m[2:-2, 2:-2] = 1
                m[4:-4, 4:-4] = 0
                m[6:-6, 6:-6] = 1 if h > 13 and w > 13 else 0
        elif kind == "edges":
            side = i % 5
            y0, x0 = rng.integers(0, max(h - 1, 1)), rng.integers(0, max(w - 1, 1))
            if side == 0:
                m[0:y0 + 1, x0:] = 1
            elif side == 1:
                m[y0:, 0:x0 + 1] = 1
            elif side == 2:
                m[:, x0:] = 1
            elif side == 3:
                m[y0:, :] = 1
            else:
                m[:] = 1
        elif kind == "lines":
            for _ in range(rng.integers(1, 4)):
                if rng.uniform() < 0.5:
                    m[rng.integers(0, h), rng.integers(0, w):] = 1
                else:
                    m[rng.integers(0, h):, rng.integers(0, w)] = 1
        elif kind == "noise":
            m = (rng.uniform(size=(h, w)) < rng.uniform(0.1, 0.9)).astype(np.uint8)
        out.append(m if kind != "empty" else np.zeros((h, w), np.uint8))
    return out


KINDS = ["pixels", "diagonal", "holes", "edges", "lines", "noise", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_contours_equal_cv2(kind):
    for m in contour_masks(kind):
        want = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        got = find_external_contours(m * 255)
        assert len(got) == len(want), m.tolist()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(-1, 2), err_msg=str(m.tolist()))


@pytest.mark.parametrize("strategy", ["largest", "concat"])
def test_masks2segments_equal_jax(strategy):
    for kind in KINDS:
        for m in contour_masks(kind, n=8, seed=1):
            stack = np.stack([m, 1 - m, m])
            want = jax_mask_ops.masks2segments(stack, strategy)
            got = mask_ops.masks2segments(torch.from_numpy(stack).bool(), strategy)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert g.dtype == np.float32 and g.shape[1:] == (2,)
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# mask post-processing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_process_mask_upsample_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    protos = rng.normal(0, 1, (16, 16, 4)).astype(np.float32)
    coefs = rng.normal(0, 1.5, (6, 4)).astype(np.float32)
    xy = rng.uniform(0, 40, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (6, 2))], 1).astype(np.float32)
    want = np.asarray(jax_mask_ops.process_mask_upsample(
        jnp.asarray(protos), jnp.asarray(coefs), jnp.asarray(boxes), shape, binarize=False))
    args = (torch.from_numpy(protos).permute(2, 0, 1), torch.from_numpy(coefs),
            torch.from_numpy(boxes), shape)
    got = mask_ops.process_mask_upsample(*args, binarize=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    flips = mask_ops.process_mask_upsample(*args).numpy() != (want > 0.5)
    assert not (flips & (np.abs(want - 0.5) >= 1e-5)).any()
    assert (want > 0.5).any() and (want <= 0.5).any()


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_resize_linear_f32_equals_cv2(channels):
    rng = np.random.default_rng(channels or 0)
    for _ in range(40):
        h, w = rng.integers(1, 40, 2)
        nh, nw = (int(v) for v in rng.integers(1, 100, 2))
        img = rng.uniform(0, 1, (h, w) if channels is None else (h, w, channels)).astype(np.float32)
        x = torch.from_numpy(img if channels is None else np.moveaxis(img, -1, 0))
        got = mask_ops.resize_linear_f32(x, nh, nw).numpy()
        got = got if channels is None else np.moveaxis(got, 0, -1)
        cv2.ipp.setUseIPP(False)
        try:
            want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        finally:
            cv2.ipp.setUseIPP(True)
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        ipp = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got.reshape(ipp.shape), ipp, rtol=0, atol=IPP_GAP)


def test_json_mask_chain_matches_jax_cv2_chain():
    """JAX's save_json chain (binary proto masks, cv2.resize to the input,
    scale_image to the frame, > 0.5) against resize_linear_f32 +
    scale_image: flips only where cv2's value lies within IPP_GAP of
    0.5, and those are counted."""
    rng = np.random.default_rng(3)
    flips = near = total = 0
    for shape0 in ((48, 64), (80, 60), (37, 53), (64, 64)):
        pm = (rng.uniform(size=(7, 16, 16)) < 0.4).astype(np.float32)
        up = np.stack([cv2.resize(m, (IMGSZ, IMGSZ), interpolation=cv2.INTER_LINEAR) for m in pm])
        soft = jax_mask_ops.scale_image((IMGSZ, IMGSZ), up.transpose(1, 2, 0), shape0)
        soft = soft.transpose(2, 0, 1)
        got = mask_ops.scale_image((IMGSZ, IMGSZ), mask_ops.resize_linear_f32(
            torch.from_numpy(pm), IMGSZ, IMGSZ), shape0).numpy()
        assert got.shape == soft.shape == (7, *shape0)
        tie = np.abs(soft - 0.5) < IPP_GAP
        diff = (got > 0.5) != (soft > 0.5)
        assert not (diff & ~tie).any()
        flips, near, total = flips + diff.sum(), near + tie.sum(), total + diff.size
    assert flips <= near <= 1e-2 * total


# ---------------------------------------------------------------------------
# COCO JSON
# ---------------------------------------------------------------------------

def test_rle_hand_vectors():
    assert coco.binary_mask_to_rle(np.ones((1, 1), np.uint8)) == {"size": [1, 1], "counts": "01"}
    rle0 = coco.binary_mask_to_rle(np.zeros((2, 3), np.uint8))
    assert rle0["size"] == [2, 3] and not coco.rle_to_binary_mask(rle0).any()


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (13, 17), (64, 48), (200, 200)])
def test_rle_round_trip_and_jax_strings(shape):
    rng = np.random.default_rng(shape[0])
    m = (rng.uniform(size=shape) > 0.6).astype(np.uint8)
    if shape == (200, 200):     # long runs: multi-char counts and negative deltas
        m[:] = 0
        m[50:150, :] = 1
    rle = coco.binary_mask_to_rle(m)
    assert rle == jax_coco.binary_mask_to_rle(m)
    np.testing.assert_array_equal(coco.rle_to_binary_mask(rle), m)
    assert coco.rle_string_to_counts(rle["counts"]) == jax_coco.rle_string_to_counts(rle["counts"])
    assert all(48 <= ord(c) < 112 for c in rle["counts"])
    stack = torch.from_numpy(np.stack([m, 1 - m, np.zeros_like(m), np.ones_like(m)]))
    assert coco.masks_to_rles(stack) == [coco.binary_mask_to_rle(x) for x in stack.numpy()]


def test_save_one_json_and_write_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    boxes = np.array([[10.0, 20.0, 110.0, 80.0], [5.0, 5.0, 25.0, 45.0], [1.2345, 2.5, 3.75, 9.0]])
    scores = np.array([0.9, 0.4, 0.123456789])
    classes = np.array([0.0, 2.0, 79.0])
    masks = (rng.uniform(size=(3, 60, 61)) > 0.5).astype(np.uint8)
    for path, cmap in (("000123.jpg", coco.coco80_to_coco91_class()), ("frame_a.png", None)):
        want, got, got_t = [], [], []
        jax_coco.save_one_json(want, path, boxes, scores, classes, pred_masks=masks, class_map=cmap)
        coco.save_one_json(got, path, boxes, scores, classes, pred_masks=masks, class_map=cmap)
        coco.save_one_json(got_t, path, boxes, scores, classes,
                           pred_masks=torch.from_numpy(masks).bool(), class_map=cmap)
        assert json.dumps(got) == json.dumps(got_t) == json.dumps(want)
    assert coco.coco80_to_coco91_class() == jax_coco.coco80_to_coco91_class()
    out = coco.write_predictions_json(got, tmp_path / "p")
    assert out.read_bytes() == jax_coco.write_predictions_json(want, tmp_path / "j").read_bytes()
    assert coco.evaluate_coco_json(out, tmp_path / "missing.json") is None   # no pycocotools


# ---------------------------------------------------------------------------
# the predictor on a video
# ---------------------------------------------------------------------------

def write_video(path: Path, n: int = N_VIDEO, seed: int = 0, fps: float = 10.0):
    rng = np.random.default_rng(seed)
    h, w = VIDEO_HW
    wtr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        base = 127 + 100 * np.sin(xx / (3 + i) + rng.uniform(0, 6)) * np.cos(yy / (4 + i))
        wtr.write(np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8))
    wtr.release()
    return path


def count_frames(path) -> int:
    cap, n = cv2.VideoCapture(str(path)), 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.fixture(scope="module")
def video_runs(tmp_path_factory):
    """The mp4, and JAX's and the port's runs on it with --save-txt
    --save-crop --visualize (JAX's predict_images with its Pallas letterbox
    in interpret mode, as the port letterboxes with K1's plain version; the
    port through its CLI with --data and --retina-masks)."""
    root = tmp_path_factory.mktemp("video")
    video = write_video(root / "clip.mp4")
    jm, v = primed_tiny()
    (root / "tiny.json").write_text(json.dumps(TINY_SEG))
    torch.save(state_dict_from_flax(v), root / "tiny.pt")
    (root / "data.json").write_text(json.dumps({"nc": TINY_NC, "names": list(NAMES.values())}))
    kw = dict(imgsz=IMGSZ, conf_thres=0.25, iou_thres=0.45, max_det=300)
    want = jax_predictor.predict_images(jm, v, str(video), nm=4, names=NAMES, save_txt=True,
                                        save_crop=True, device_preprocess=True,
                                        save_dir=str(root / "jax"), **kw)
    got = predict_cli.run(weights=str(root / "tiny.pt"), cfg=str(root / "tiny.json"),
                          source=str(video), data=str(root / "data.json"), save_txt=True,
                          save_crop=True, visualize=True, retina_masks=True, device="cpu",
                          project=str(root), name="port", **kw)
    return dict(root=root, video=video, jm=jm, v=v, want=want, got=got)


def test_video_detections_match_jax(video_runs):
    want, got = video_runs["want"], video_runs["got"]
    assert len(got) == len(want) == N_VIDEO
    rows = 0
    for w, g in zip(want, got):
        assert g.shape[1] == w.shape[1] == 6 + 4
        _, ties, left_w, left_g = pair_detections(w[:, :6], g[:, :6], conf_thres=0.25,
                                                  conf_tol=1e-5)
        assert len(g) == len(w) and not len(left_w) and not len(left_g), ties
        rows += len(w)
    assert rows > N_VIDEO
    root = video_runs["root"]
    assert count_frames(root / "port" / "clip.mp4") == count_frames(root / "jax" / "clip.mp4") \
        == N_VIDEO


def test_txt_rows_with_frame_suffix_match_jax(video_runs):
    root = video_runs["root"]
    names = sorted(p.name for p in (root / "jax" / "labels").glob("*.txt"))
    assert names == sorted(p.name for p in (root / "port" / "labels").glob("*.txt"))
    assert names == [f"clip_{k}.txt" for k in range(1, N_VIDEO + 1)]
    for n in names:
        want = np.loadtxt(root / "jax" / "labels" / n, ndmin=2)
        got = np.loadtxt(root / "port" / "labels" / n, ndmin=2)
        want, got = want[np.lexsort(want.T[::-1])], got[np.lexsort(got.T[::-1])]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_crops_match_jax(video_runs):
    root = video_runs["root"]
    files = sorted(p.relative_to(root / "jax") for p in (root / "jax" / "crops").rglob("*.jpg"))
    assert files and files == sorted(p.relative_to(root / "port")
                                     for p in (root / "port" / "crops").rglob("*.jpg"))
    assert {f.parts[1] for f in files} <= set(NAMES.values())   # --data's names
    n_rows = sum(len(g) for g in video_runs["got"])
    assert len(files) == n_rows   # a crop a kept detection
    sizes = sorted(cv2.imread(str(root / "jax" / f)).shape for f in files)
    assert sizes == sorted(cv2.imread(str(root / "port" / f)).shape for f in files)


def test_feature_maps_match_jax(video_runs, tmp_path, monkeypatch):
    """The port's panels carry the names JAX's feature_visualization gives
    its intermediates of the first frame (matplotlib here); without
    matplotlib the maps themselves (.npy) equal those intermediates (1e-4:
    the port's model is conv+BN-folded). JAX's own --visualize draws the
    fused graph, whose yolov5 stem (layers 0-3) JAX rewrites into a
    space-to-depth layout (JAX models/model.py fuse(blocked=...)), so its
    panels of those layers show that layout (ROADMAP §C); the port's, and
    this comparison, are the layers' true outputs: JAX's unfused graph."""
    from yolo_dual_tpu.kernels import letterbox_normalize as jax_letterbox
    from yolo_dual_tpu.utils.plots import feature_visualization as jax_feature_visualization
    root, jm, v = video_runs["root"], video_runs["jm"], video_runs["v"]
    first = next(predictor.iter_source(str(video_runs["video"])))[1]
    x = jax_letterbox(jnp.asarray(first[None]), IMGSZ, interpret=True)
    _, inter = jax.jit(lambda v, x: jm.module.apply(
        v, x, train=False, capture_intermediates=True, mutable=["intermediates"]))(v, x)
    inter = {int(k.split("_")[1]): np.asarray(o["__call__"][0])
             for k, o in inter["intermediates"].items()
             if k.startswith("model_") and hasattr(o["__call__"][0], "ndim")}
    for i, o in inter.items():
        jax_feature_visualization(o, f"model_{i}", i, save_dir=tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert names == sorted(p.name for p in (root / "port" / "features").glob("*.png"))
    assert names == [f"stage{i}_model_{i}.png" for i in range(len(TINY_SEG["backbone"]))]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    predictor.predict_images(predict_cli_model(root), [first], imgsz=IMGSZ, save_img=False, nm=4,
                             visualize=True, save_dir=str(tmp_path / "f"), device="cpu")
    for i in range(len(TINY_SEG["backbone"])):
        got = np.load(tmp_path / "f" / "features" / f"stage{i}_model_{i}.npy")
        np.testing.assert_allclose(got, np.moveaxis(inter[i][0], -1, 0)[:32], rtol=0, atol=1e-4)


def predict_cli_model(root):
    from yolo_dual_tpu_torch.io.weights import load_state_dict_file
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    m = SegmentationModel(str(root / "tiny.json"), nc=TINY_NC, device="cpu")
    m.load_state_dict(load_state_dict_file(root / "tiny.pt"), strict=True)
    return m


@pytest.mark.parametrize("vid_stride,max_frames", [(1, None), (2, None), (2, 2), (1, 4), (3, 1)])
def test_vid_stride_and_max_frames(video_runs, vid_stride, max_frames):
    want = list(jax_predictor.iter_source(str(video_runs["video"]), vid_stride=vid_stride,
                                          max_frames=max_frames))
    got = list(predictor.iter_source(str(video_runs["video"]), vid_stride=vid_stride,
                                     max_frames=max_frames))
    assert len(got) == len(want) > 0
    for (gp, gim, gfps), (wp, wim, wfps) in zip(got, want):
        assert gp == wp and gfps == wfps == 10.0
        np.testing.assert_array_equal(gim, wim[..., ::-1])


def test_streams_file_reads_a_local_video(video_runs, tmp_path):
    lst = tmp_path / "cams.streams"
    lst.write_text(f"{video_runs['video']}\n\n")
    assert streams.is_stream_source(lst) and streams.is_stream_source("0")
    assert not streams.is_stream_source(video_runs["video"])
    before = threading.active_count()
    got = list(predictor.iter_source(str(lst), max_frames=3))
    want = list(jax_predictor.iter_source(str(lst), max_frames=3))
    assert len(got) == len(want) == 3
    assert all(f.shape == (*VIDEO_HW, 3) and fps == 10.0 and p == str(video_runs["video"])
               for p, f, fps in got)
    loader = streams.LoadStreams(str(lst))
    assert loader.sources == [str(video_runs["video"])] and loader.fps == [10.0]
    loader.close()
    assert not any(t.is_alive() for t in loader.threads)
    assert threading.active_count() <= before


def test_screen_raises_without_mss():
    assert streams.is_screenshot_source("screen 0 10 10 32 32")
    for iter_source in (predictor.iter_source, jax_predictor.iter_source):
        with pytest.raises(ImportError, match="mss"):
            next(iter(iter_source("screen", max_frames=1)))
    with pytest.raises(ImportError, match="mss"):
        streams.LoadScreenshots("screen")
    with pytest.raises(ImportError, match="mss"):
        jax_streams.LoadScreenshots("screen")


def test_npy_outputs_without_cv2_and_matplotlib(video_runs, tmp_path, monkeypatch):
    """Crops and feature maps as `.npy` on a machine without cv2 and
    matplotlib; a crop holds the frame's RGB pixels of JAX's crop."""
    frames = [f for _, f, _ in predictor.iter_source(str(video_runs["video"]), max_frames=2)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = predictor.predict_images(predict_cli_model(video_runs["root"]), frames, imgsz=IMGSZ, nm=4,
                                   save_img=False, save_crop=True, visualize=True,
                                   save_dir=str(tmp_path / "run"), names=NAMES, device="cpu")
    out = tmp_path / "run"
    crops = sorted((out / "crops").rglob("*.npy"))
    assert len(crops) == sum(len(r) for r in res) and not list(out.rglob("*.jpg"))
    assert len(list((out / "features").glob("*.npy"))) == len(TINY_SEG["backbone"])
    from yolo_dual_tpu_torch.ops.boxes import scale_boxes
    d = res[0][0]
    box = scale_boxes((IMGSZ, IMGSZ), torch.from_numpy(d[None, :4]), VIDEO_HW)[0].numpy()
    want = save_one_box(box, frames[0], save=False)[..., ::-1]
    first = out / "crops" / NAMES[int(d[5])] / "frame0.npy"
    np.testing.assert_array_equal(np.load(first), want)
    with pytest.raises(ImportError, match="cv2"):
        list(predictor.iter_source(str(video_runs["video"])))


def test_update_strips_a_training_checkpoint(video_runs, tmp_path):
    root = video_runs["root"]
    sd = torch.load(root / "tiny.pt", weights_only=True)
    ckpt = tmp_path / "last.pt"
    save_checkpoint(ckpt, {"model": sd, "ema": sd, "updates": 3, "epoch": 2,
                           "optimizer": {"state": {}, "param_groups": []}})
    plain = tmp_path / "plain.pt"
    plain.write_bytes((root / "tiny.pt").read_bytes())
    kw = dict(cfg=str(root / "tiny.json"), source=str(video_runs["video"]), nc=TINY_NC,
              imgsz=IMGSZ, nosave=True, device="cpu", max_frames=2, update=True, half=True,
              dnn=True, project=str(tmp_path), name="u")
    got = predict_cli.run(weights=str(ckpt), **kw)
    stripped = load_checkpoint(ckpt)
    assert stripped["optimizer"] is None and stripped["epoch"] == -1
    again = predict_cli.run(weights=str(plain), **kw)
    assert plain.read_bytes() == (root / "tiny.pt").read_bytes()   # a state_dict stays
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    opt = predict_cli.parse_opt(["--update", "--half", "--dnn", "--retina-masks", "--view-img",
                                 "--save-crop", "--visualize", "--vid-stride", "2",
                                 "--max-frames", "3", "--data", "d.json"])
    assert opt.vid_stride == 2 and opt.max_frames == 3 and opt.data == "d.json" and opt.update


def test_view_img_shows_each_frame(video_runs, tmp_path, monkeypatch):
    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda name, im: shown.append((name, im.shape)))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    root = video_runs["root"]
    predict_cli.run(weights=str(root / "tiny.pt"), cfg=str(root / "tiny.json"), nc=TINY_NC,
                    source=str(video_runs["video"]), imgsz=IMGSZ, nosave=True, view_img=True,
                    vid_stride=2, device="cpu", project=str(tmp_path))
    assert shown == [(str(video_runs["video"]), (*VIDEO_HW, 3))] * 3


# ---------------------------------------------------------------------------
# classify.predict on the video
# ---------------------------------------------------------------------------

MINI = dict(nc=3, depth_multiple=1.0, width_multiple=1.0,
            backbone=[[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]], head=[])


def test_classify_predict_video_matches_jax(video_runs, tmp_path):
    """JAX's initial weights under PRNGKey(0) on both sides (1000 classes):
    the top-5 probabilities within 1e-5, their classes equal where they are
    not within 1e-5 of each other, the txt rows a frame, an mp4 out."""
    from yolo_dual_tpu_torch.classify import predict as cls_predict
    (tmp_path / "mini.yaml").write_text(yaml.safe_dump(MINI))
    (tmp_path / "mini.json").write_text(json.dumps(MINI))
    key = "jax_classify_predict_vs_port_video"
    if key not in sys.modules:
        sys.path.insert(0, str(ROOT / "classify"))   # predict.py imports `train`
        spec = importlib.util.spec_from_file_location(key, ROOT / "classify" / "predict.py")
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    kw = dict(source=str(video_runs["video"]), imgsz=32, cutoff=2, topk=5, save_txt=True,
              vid_stride=2, project=str(tmp_path))
    want = sys.modules[key].run(model=str(tmp_path / "mini.yaml"), name="jax", **kw)
    got = cls_predict.run(model=str(tmp_path / "mini.json"), name="port", device="cpu", **kw)
    assert len(got) == len(want) == 3
    for (gp, go, gprob), (wp, wo, wprob) in zip(got, want):
        assert gp == wp
        np.testing.assert_allclose(gprob, wprob, rtol=0, atol=1e-5)
        apart = np.abs(np.diff(wprob)) > 1e-5
        assert go[0] == wo[0] or not apart[0]
        np.testing.assert_array_equal(np.sort(go[:-1][apart]), np.sort(wo[:-1][apart]))
    for k in (1, 2, 3):
        g = (tmp_path / "port" / "labels" / f"clip_{k}.txt").read_text().split()
        w = (tmp_path / "jax" / "labels" / f"clip_{k}.txt").read_text().split()
        assert len(g) == len(w) == 10 and g[::2] == w[::2]
    assert count_frames(tmp_path / "port" / "clip.mp4") == count_frames(
        tmp_path / "jax" / "clip.mp4") == 3
