"""Test-time augmentation and soft-NMS in the port against the JAX package on
the CPU (models/model.py: scale_img, forward_augment; ops/nms.py:
soft_nms_padded, nms_batched, non_max_suppression, nms_from_raw's
use_soft_nms; evaluate_segment and predict_images with augment and
use_soft_nms; the --augment and --soft-nms flags of segment.val and
segment.predict).

Tolerances: scale_img and forward_augment within 1e-4 of the largest value
(JAX's antialiased resize against F.interpolate's); the NMS functions keep
JAX's rows (the same candidates, in the same order) on inputs with tied
scores, equal but for soft-NMS's decayed scores, which take XLA's exp
against torch's and stand within 1e-6 relative (a float32 ulp or two);
evaluate_segment's metrics within 1e-4 on tests/torch_port_common.py's
primed TINY_SEG; predict_images(augment=True) keeps JAX's rows (the same
count per frame, every row within 1e-3 px and 1e-5 of confidence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_eval import ANCHORS, NM, STRIDES, BatchLoader, self_labelled_batches, tied_maps
from torch_port_common import IMGSZ, ROOT, TINY_NC, TINY_NM, port_model, primed_tiny, \
    random_variables
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu.engine import predict_images as jax_predict_images
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu.models.model import forward_augment as jax_forward_augment
from yolo_dual_tpu.models.model import scale_img_nhwc as jax_scale_img
from yolo_dual_tpu.ops import nms as jax_nms
from yolo_dual_tpu_torch.engine.predictor import predict_images
from yolo_dual_tpu_torch.engine.validator import evaluate_segment
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import build_model, forward_augment, scale_img
from yolo_dual_tpu_torch.ops import nms
from yolo_dual_tpu_torch.segment import predict as predict_cli
from yolo_dual_tpu_torch.segment import val as val_cli

SHARE = 1e-4


def assert_close_share(got, want, share=SHARE):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= share * np.abs(want).max(), np.abs(got - want).max()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("ratio", [1.0, 0.83, 0.67])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 50, 70, 3)], ids=["square", "odd"])
def test_scale_img_matches_jax(ratio, shape):
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = jax_scale_img(jnp.asarray(x), ratio, 32)
    got = scale_img(nchw(x), ratio, 32).permute(0, 2, 3, 1)
    assert_close_share(got, want)


def detect_model():
    """A narrow yolov5n (width 1/16, nc 80) in JAX and in the port, same weights."""
    import yaml
    d = yaml.safe_load((ROOT / "yolo_dual_tpu" / "configs" / "models" / "yolov5n.yaml").read_text())
    d["width_multiple"] = 1 / 16
    jm = jax_build_model(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=2)
    port = build_model(d, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, port


@pytest.mark.parametrize("head", ["segment", "detect"])
def test_forward_augment_matches_jax(head):
    """The three passes, descaled, deflipped and clipped: the predictions,
    and for a Segment head the identity pass' protos."""
    if head == "segment":
        jm, v = primed_tiny()
        port = port_model(v)
    else:
        jm, v, port = detect_model()
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want, want_protos = jax.jit(lambda v, x: jax_forward_augment(jm, v, x))(v, jnp.asarray(x))
    with torch.no_grad():
        got, protos = forward_augment(port.eval(), nchw(x))
    nc = TINY_NC if head == "segment" else 80
    assert got.shape[2] == 5 + nc + (TINY_NM if head == "segment" else 0)
    assert_close_share(got[..., :4], np.asarray(want)[..., :4])
    assert_close_share(got[..., 4:], np.asarray(want)[..., 4:])
    if head == "segment":
        assert_close_share(protos.permute(0, 2, 3, 1), want_protos)
    else:
        assert protos is None and want_protos is None


def decoded_predictions(seed, bs=3, n=400, nc=4, nm=3):
    """Decoded predictions with tied scores (rows 10-19 repeat rows 0-9's)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((bs, n, 5 + nc + nm), np.float32)
    x[..., :2] = rng.uniform(0, 200, (bs, n, 2))
    x[..., 2:4] = rng.uniform(5, 60, (bs, n, 2))
    x[..., 4:5 + nc] = rng.uniform(0, 1, (bs, n, 1 + nc))
    x[..., 5 + nc:] = rng.normal(0, 1, (bs, n, nm))
    x[:, 10:20, 4:] = x[:, 0:10, 4:]
    x[:, 20:30, 4:5 + nc] = 1.0  # saturated scores
    return x


@pytest.mark.parametrize("soft", [False, True], ids=["greedy", "soft"])
@pytest.mark.parametrize("multi_label", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("agnostic", [False, True], ids=["offset", "agnostic"])
def test_nms_batched_matches_jax(soft, multi_label, agnostic):
    x = decoded_predictions(0)
    kw = dict(conf_thres=0.3, iou_thres=0.45, multi_label=multi_label, agnostic=agnostic,
              max_det=300, nm=3, use_soft_nms=soft)
    want, want_n = (np.asarray(a) for a in jax_nms.nms_batched(jnp.asarray(x), **kw))
    got, got_n = nms.nms_batched(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if soft else 0, atol=0)


@pytest.mark.parametrize("threshold,max_det", [(0.35, 300), (0.9, 300), (0.2, 20)],
                         ids=["long", "short", "max_det"])
def test_soft_nms_padded_matches_jax(threshold, max_det):
    """JAX's rows and selection-time scores, image by image: the loop bounded
    by the count of scores above the threshold (short: a few steps) or by
    max_det, and the images that stop before the others."""
    x = decoded_predictions(1)
    x[1, :, 4] *= 0.5  # the second image stops first
    boxes = np.concatenate([x[..., :2], x[..., :2] + x[..., 2:4]], -1)
    keep, kept = nms.soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(x[..., 4]), 0.3,
                                     max_det, score_threshold=threshold)
    for i in range(len(x)):
        wk, ws = jax_nms.soft_nms_padded(jnp.asarray(boxes[i]), jnp.asarray(x[i, :, 4]), 0.3,
                                         max_det, score_threshold=threshold)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(wk))
        np.testing.assert_allclose(kept[i].numpy(), np.asarray(ws), rtol=1e-6, atol=0)
    n = (keep >= 0).sum(1).tolist()
    assert {"long": 0 < n[1] < n[0] < max_det, "short": 0 < max(n) < 60,
            "max_det": min(n) == max_det}[
        {0.35: "long", 0.9: "short", 0.2: "max_det"}[threshold]], n


@pytest.mark.parametrize("soft", [False, True], ids=["greedy", "soft"])
def test_non_max_suppression_matches_jax(soft):
    x = decoded_predictions(2)
    kw = dict(conf_thres=0.3, iou_thres=0.45, classes=[1, 2], nm=3, use_soft_nms=soft)
    want = jax_nms.non_max_suppression(jnp.asarray(x), **kw)
    got = nms.non_max_suppression(torch.from_numpy(x), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6 if soft else 0, atol=0)
        assert set(np.unique(w[:, 5])) <= {1.0, 2.0}


@pytest.mark.parametrize("multi_label", [False, True], ids=["serving", "multi"])
def test_nms_from_raw_soft_matches_jax(multi_label):
    """use_soft_nms off the raw maps, on tests/test_torch_port_eval.py's tied
    maps (half the cells at logit 30)."""
    raw = tied_maps(5, imgsz=128)
    kw = dict(conf_thres=0.25, iou_thres=0.45, multi_label=multi_label, max_det=100, nm=NM,
              pre_nms_topk=256, use_soft_nms=True)
    want, want_n = (np.asarray(a) for a in jax_nms.nms_from_raw(
        [jnp.asarray(r) for r in raw], ANCHORS, STRIDES, **kw))
    got, got_n = nms.nms_from_raw([torch.from_numpy(r) for r in raw], ANCHORS, STRIDES, **kw)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    for i, n in enumerate(want_n):
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    return primed_tiny()


@pytest.mark.parametrize("augment,soft", [(True, False), (False, True), (True, True)],
                         ids=["augment", "soft_nms", "both"])
def test_evaluate_segment_matches_jax(tiny, augment, soft):
    """evaluate_segment(augment=..., use_soft_nms=...) against JAX's on the
    self-labelled TINY_SEG batches of tests/test_torch_port_eval.py (the
    image_raw route: the letterbox kernel's plain version here)."""
    jm, v = tiny
    loader = BatchLoader(self_labelled_batches(v, overlap=True, raw=True))
    kw = dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM, augment=augment, use_soft_nms=soft)
    want, want_maps, _ = jax_evaluate_segment(jm, v, loader, TINY_NC, **kw)
    got, got_maps, _ = evaluate_segment(port_model(v), loader, TINY_NC, device="cpu", **kw)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05 and got[6] > 0.05, got


def test_predict_images_augment_matches_jax(tiny, tmp_path):
    """predict_images(augment=True), alone and with soft-NMS, against JAX's
    (its letterbox in interpret mode) on three seeded frames: JAX reads them
    as PNG files, the port takes them in memory."""
    cv2 = pytest.importorskip("cv2")  # JAX's predictor reads frames with cv2
    jm, v = tiny
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.default_rng(4)
    frames = []
    for i, (h, w) in enumerate(((48, 64), (80, 60), (64, 64))):
        yy, xx = np.mgrid[0:h, 0:w]
        im = 127 + 100 * np.sin(xx / (3 + i)) * np.cos(yy / (4 + i))
        frames.append(np.clip(im[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255)
                      .astype(np.uint8))
        cv2.imwrite(str(src / f"im{i}.png"), frames[-1][..., ::-1])
    for soft in (False, True):
        kw = dict(imgsz=IMGSZ, conf_thres=0.25, nm=TINY_NM, save_img=False, augment=True,
                  use_soft_nms=soft)
        want = jax_predict_images(jm, v, str(src), device_preprocess=True,
                                  save_dir=str(tmp_path / f"jax{soft}"), **kw)
        got = predict_images(port_model(v), frames, device="cpu",
                             save_dir=str(tmp_path / f"port{soft}"), **kw)
        assert len(got) == len(want) == 3 and sum(len(w) for w in want) > 5
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=0, atol=1e-5)


def test_clis_take_augment_and_soft_nms():
    opt = val_cli.parse_opt(["--data", "d", "--augment", "--soft-nms"])
    assert opt.augment and opt.soft_nms
    opt = predict_cli.parse_opt(["--source", "s", "--augment", "--soft-nms"])
    assert opt.augment and opt.soft_nms
