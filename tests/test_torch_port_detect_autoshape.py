"""The port's hub API, `engine/autoshape.py` (AutoShape, Detections), against
JAX's on the CPU from the same seeded weights: narrow yolov5s-ghost,
yolov5s-transformer, yolov3-tiny and yolov5n-FPN-AS (width_multiple 1/16)
and the Segment net TINY_SEG, over three seeded frames of mixed sizes given
as a numpy array, a PIL image and a PNG file.

Tolerances: the same detections (count and classes), boxes within 1e-3 px and
confidences within 1e-5. A row whose confidence lies within 1e-4 of the
threshold or of another row's is a near tie: float32 rounding may drop it or
swap it, so such rows are counted and left out. Segment masks agree on all
but 1% of a detection's pixels (JAX un-letterboxes them with cv2.resize, the
port with F.interpolate).
"""

import numpy as np
import pytest
import yaml

from torch_port_common import IMGSZ as TINY_IMGSZ, ROOT, TINY_SEG, primed_tiny, random_variables
from yolo_dual_tpu.engine.autoshape import AutoShape as JaxAutoShape
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu_torch.engine.autoshape import AutoShape, Detections
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import build_model
from detection_matching import pair_detections

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

JAX_CFG = ROOT / "yolo_dual_tpu" / "configs"
CONFIGS = ("hub/yolov5s-ghost", "hub/yolov5s-transformer", "hub/yolov3-tiny",
           "attention/yolov5n-FPN-AS")
IMGSZ, CONF, MAX_DET, NEAR = 64, 0.25, 300, 1e-4
SHAPES = ((48, 80), (64, 64), (90, 50))


def write_frames(tmp_path, seed):
    """Three seeded RGB frames with bright rectangles, and the inputs of both
    packages: an array, a PIL image and a PNG path."""
    rng = np.random.default_rng(seed)
    ims = []
    for h, w in SHAPES:
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for _ in range(3):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            im[y0:y0 + rng.integers(8, h // 2), x0:x0 + rng.integers(8, w // 2)] = \
                rng.integers(150, 256, 3)
        ims.append(im)
    cv2.imwrite(str(tmp_path / "f2.png"), ims[2][..., ::-1])
    return ims, [ims[0], Image.fromarray(ims[1]), str(tmp_path / "f2.png")]


def assert_same_detections(got, want, conf, iou=0.45):
    """The rows of two Detections agree but for counted near ties
    (detection_matching.pair_detections); the port's to_dicts rows carry JAX's keys
    and names. Returns (pairs, near ties)."""
    assert len(got) == len(want)
    pairs = near = 0
    for g, w, rg, rw in zip(got.dets, want.dets, got.to_dicts(), want.to_dicts()):
        assert g.shape[1] == w.shape[1] and len(rg) == len(g) and len(rw) == len(w)
        n, k, left_w, left_g = pair_detections(w, g, conf, iou, box_tol=1e-3, conf_tol=1e-5,
                                               near=NEAR)
        assert len(left_w) == len(left_g) == 0, (left_w, left_g)
        pairs, near = pairs + n, near + k
        assert {tuple(sorted(r)) for r in rg + rw} <= {tuple(sorted(rw[0] if rw else rg[0]))}
        assert {r["name"] for r in rg} <= set(want.names.values())
        assert {(r["class"], r["name"]) for r in rg} <= {(c, want.names[c]) for c in want.names}
    return pairs, near


@pytest.mark.parametrize("name", CONFIGS)
def test_autoshape_matches_jax(name, tmp_path):
    d = yaml.safe_load((JAX_CFG / f"{name}.yaml").read_text())
    d["width_multiple"] = 1 / 16
    jm = jax_build_model(d)
    ims, inputs = write_frames(tmp_path, seed=len(name))
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=len(name))
    port = build_model(d, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    names = {i: f"class{i}" for i in range(80)}
    want = JaxAutoShape(jm, v, imgsz=IMGSZ, conf=CONF, max_det=MAX_DET, names=names)(inputs)
    got = AutoShape(port, imgsz=IMGSZ, conf=CONF, max_det=MAX_DET, names=names)(inputs)
    assert isinstance(got, Detections) and len(got) == 3 and got.masks == [None] * 3
    for im, g in zip(ims, got.ims):
        np.testing.assert_array_equal(g, im)
    rows, near = assert_same_detections(got, want, CONF)
    print(f"{name}: {rows} rows compared, {near} near ties")
    assert rows >= 30 and near <= 0.02 * rows and max(len(d) for d in want.dets) < MAX_DET
    assert all(t >= 0 for t in got.t)


def test_autoshape_segment_masks_match_jax(tmp_path):
    """TINY_SEG (primed as JAX's dryrun primes it) through both AutoShapes at
    low confidence: the same detections, and masks at image size."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    jm, v = primed_tiny()
    port = SegmentationModel(TINY_SEG, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    ims, inputs = write_frames(tmp_path, seed=7)
    conf = 0.01
    want = JaxAutoShape(jm, v, imgsz=TINY_IMGSZ, conf=conf, max_det=30)(inputs)
    got = AutoShape(port, imgsz=TINY_IMGSZ, conf=conf, max_det=30)(inputs)
    rows, _ = assert_same_detections(got, want, conf)
    assert rows >= 3
    for im, g, w, dg, dw in zip(ims, got.masks, want.masks, got.dets, want.dets):
        assert g.shape == w.shape == (len(dg), *im.shape[:2]) and g.dtype == bool
        n = min(len(dg), len(dw))
        assert (g[:n] != w[:n]).mean() <= 0.01


def test_detections_exports_and_refusals(tmp_path, monkeypatch):
    """render, save, crop, pandas, print and to_dicts on the port's
    Detections; a path without cv2 names the missing module; AutoShape
    refuses a model without a Detect head."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    _, v = primed_tiny()
    port = SegmentationModel(TINY_SEG, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    ims, inputs = write_frames(tmp_path, seed=9)
    res = AutoShape(port, imgsz=TINY_IMGSZ, conf=0.01, max_det=5,
                    names={0: "a", 1: "b", 2: "c"})(inputs)
    n_det = sum(len(d) for d in res.dets)
    assert n_det > 0 and all(r.shape == im.shape for r, im in zip(res.render(), ims))
    assert len(list(res.save(tmp_path / "saved").glob("image*.jpg"))) == 3
    assert len(list(res.crop(tmp_path / "crops").rglob("*.jpg"))) == n_det
    frames = res.pandas()
    assert [len(f) for f in frames] == [len(d) for d in res.dets]
    assert {r["name"] for r in sum(res.to_dicts(), [])} <= {"a", "b", "c"}
    res.print()
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        AutoShape._to_rgb(str(tmp_path / "f2.png"))
    semantic = build_model("resnet18.json", device="cpu")
    with pytest.raises(NotImplementedError, match="Detect"):
        AutoShape(semantic)
