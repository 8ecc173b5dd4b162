"""The prediction slice end to end: the port's predict_images on the CPU
against the JAX predict_images (Pallas letterbox in interpret mode), on the
same seeded frames and weights, plus the port's CLI.

Random weights give many candidates with close scores. A different summation
order can reorder two near-tied candidates and so change which of them NMS
keeps, so the rule is statistical: per frame the kept counts agree within 2%,
and at least 98% of the JAX rows have a port row of the same class with
IoU > 0.99 and a confidence within 1e-4.
"""

import numpy as np
import pytest
import torch

from torch_port_common import SEG_CFG, random_variables
from yolo_dual_tpu.engine import predict_images as jax_predict_images
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu_torch.engine.predictor import predict_images
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.ops.boxes import match_detections
from yolo_dual_tpu_torch.segment import predict as predict_cli

cv2 = pytest.importorskip("cv2")

IMGSZ = 64
SIZES = [(48, 64), (80, 60), (64, 64)]


def _write_frames(d, seed=0):
    rng = np.random.default_rng(seed)
    d.mkdir()
    for i, (h, w) in enumerate(SIZES):
        # smooth blobs plus noise: structure for the convs, distinct per frame
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx / (3 + i) + rng.uniform(0, 6)) * np.cos(yy / (4 + i))
        im = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(d / f"im{i}.png"), im)
    return d


def test_predict_images_matches_jax(tmp_path):
    src = _write_frames(tmp_path / "frames")
    jm = JaxSegmentationModel(SEG_CFG / "yolov5n-seg.yaml")
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), seed=7)
    want = jax_predict_images(jm, v, str(src), imgsz=IMGSZ, conf_thres=1e-6, nm=32,
                              save_dir=str(tmp_path / "jax"), save_img=False,
                              device_preprocess=True)
    model = SegmentationModel("yolov5n-seg.json", device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    got = predict_images(model, str(src), imgsz=IMGSZ, conf_thres=1e-6, nm=32,
                         save_dir=str(tmp_path / "port"), save_img=False, device="cpu")
    assert len(got) == len(want) == len(SIZES)
    for w, g in zip(want, got):
        assert g.shape[1] == w.shape[1] == 6 + 32
        assert len(w) > 50  # conf_thres=1e-6 leaves NMS and masks real work
        assert abs(len(g) - len(w)) <= 0.02 * len(w)
        assert match_detections(w, g) >= 0.98


def test_in_memory_and_npy_frames_equal_image_files(tmp_path):
    """In-memory RGB frames and .npy frames (readable without cv2) take the
    same path as decoded image files."""
    src = _write_frames(tmp_path / "frames", seed=1)
    frames = [cv2.imread(str(src / f"im{i}.png"))[..., ::-1].copy() for i in range(len(SIZES))]
    npy = tmp_path / "npy"
    npy.mkdir()
    for i, f in enumerate(frames):
        np.save(npy / f"im{i}.npy", f)
    model = SegmentationModel("yolov5n-seg.json", device="cpu")
    kw = dict(imgsz=IMGSZ, conf_thres=1e-6, save_img=False, device="cpu")
    from_files = predict_images(model, str(src), save_dir=str(tmp_path / "a"), **kw)
    in_memory = predict_images(model, frames, save_dir=str(tmp_path / "b"), **kw)
    from_npy = predict_images(model, str(npy), save_dir=str(tmp_path / "c"), **kw)
    assert [p.t > 0 for p in predict_images.profiles] == [True] * 3  # pre, infer, post
    for a, b, c in zip(from_files, in_memory, from_npy):
        assert len(a) > 0
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_cli_saves_annotated_images_and_labels(tmp_path):
    src = _write_frames(tmp_path / "frames", seed=2)
    res = predict_cli.run(**vars(predict_cli.parse_opt([
        "--cfg", "yolov5n-seg.yaml", "--source", str(src), "--imgsz", "64", "--conf-thres", "1e-6",
        "--max-det", "20", "--project", str(tmp_path / "runs"), "--save-txt", "--device", "cpu"])))
    assert len(res) == len(SIZES)
    out = tmp_path / "runs" / "exp"
    for i, (h, w) in enumerate(SIZES):
        im = cv2.imread(str(out / f"im{i}.png"))
        assert im is not None and im.shape == (h, w, 3)
        rows = np.loadtxt(out / "labels" / f"im{i}.txt", ndmin=2)
        assert rows.shape == (len(res[i]), 5) and len(rows) == 20


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SegmentationModel("yolov5n-seg.json")
    model = SegmentationModel("yolov5n-seg.json", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        predict_images(model, [np.zeros((8, 8, 3), np.uint8)], imgsz=32, save_img=False)
