"""The port's post-processing ops (yolo_dual_tpu_torch/ops) against the JAX
package on identical seeded inputs: fused decode + NMS off raw head maps,
exact greedy NMS, proto mask decode, crop, box rescaling and IoU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dual_tpu.ops import boxes as jax_boxes
from yolo_dual_tpu.ops import mask_ops as jax_mask_ops
from yolo_dual_tpu.ops.nms import nms_from_raw as jax_nms_from_raw
from yolo_dual_tpu.ops.nms import nms_padded_serial as jax_greedy
from yolo_dual_tpu_torch.ops import boxes, mask_ops
from yolo_dual_tpu_torch.ops.nms import nms_from_raw, nms_padded

ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
STRIDES = (8, 16, 32)
NC, NM = 80, 32


def _raw_maps(seed, bs=2, imgsz=64):
    """Raw head maps (bs, na, ny, nx, 5+nc+nm) per level; N(0, 1) logits give
    distinct scores and overlapping anchor-sized boxes."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (bs, 3, imgsz // s, imgsz // s, 5 + NC + NM)).astype(np.float32)
            for s in STRIDES]


NMS_CASES = {  # name: kwargs shared by both implementations
    "plain": dict(conf_thres=0.25, iou_thres=0.45, max_det=300, pre_nms_topk=1024),
    "agnostic": dict(conf_thres=0.25, iou_thres=0.45, max_det=300, pre_nms_topk=1024, agnostic=True),
    "classes_mask": dict(conf_thres=0.1, iou_thres=0.45, max_det=300, pre_nms_topk=1024,
                         classes=list(range(0, NC, 7))),
    "topk_and_max_det_cut": dict(conf_thres=0.2, iou_thres=0.3, max_det=20, pre_nms_topk=64),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_from_raw_matches_jax(case):
    kw = dict(NMS_CASES[case])
    classes = kw.pop("classes", None)
    raw = _raw_maps(seed=len(case))
    cm = None
    if classes is not None:
        cm = np.zeros(NC, bool)
        cm[classes] = True
    want, want_n = jax_nms_from_raw([jnp.asarray(r) for r in raw], ANCHORS, STRIDES, nm=NM,
                                    multi_label=False, classes_mask=None if cm is None else jnp.asarray(cm),
                                    **kw)
    got, got_n = nms_from_raw([torch.from_numpy(r) for r in raw], ANCHORS, STRIDES, nm=NM,
                              classes_mask=None if cm is None else torch.from_numpy(cm), **kw)
    want, want_n = np.asarray(want), np.asarray(want_n)
    assert got.shape == want.shape and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    assert want_n.min() > 1  # the case exercises suppression, not an empty output
    for i, n in enumerate(want_n):
        # XLA's and torch's sigmoids differ in the last bits; stride and anchor
        # scale that into box coordinates of up to ~400 px, hence rtol 1e-6
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], rtol=1e-6, atol=1e-5)
        assert not got[i, n:].any()
    if cm is not None:
        assert np.isin(got[0, :want_n[0], 5].numpy(), np.flatnonzero(cm)).all()


@pytest.mark.parametrize("n,max_det,iou_thres", [(200, 300, 0.45), (300, 50, 0.3), (40, 100, 0.7)])
def test_nms_padded_equals_greedy(n, max_det, iou_thres):
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    s = rng.permutation(n).astype(np.float32) / n      # distinct, one of them 0 (invalid)
    want = np.asarray(jax_greedy(jnp.asarray(b), jnp.asarray(s), iou_thres, max_det))
    got = nms_padded(torch.from_numpy(b)[None], torch.from_numpy(s)[None], iou_thres, max_det)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def _mask_inputs(seed, n=6, c=32, mh=16, mw=16, img=64):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (mh, mw, c)).astype(np.float32)          # NHWC, the JAX layout
    coefs = rng.normal(0, 0.5, (n, c)).astype(np.float32)
    xy = rng.uniform(0, img * 0.6, (n, 2))
    b = np.concatenate([xy, xy + rng.uniform(4, img * 0.4, (n, 2))], 1).astype(np.float32)
    return protos, coefs, b


@pytest.mark.parametrize("upsample", [False, True])
def test_process_mask_matches_jax(upsample):
    protos, coefs, b = _mask_inputs(seed=int(upsample))
    args = (jnp.asarray(protos), jnp.asarray(coefs), jnp.asarray(b), (64, 64))
    want = np.asarray(jax_mask_ops.process_mask(*args, upsample=upsample, binarize=False))
    got = mask_ops.process_mask(torch.from_numpy(protos).permute(2, 0, 1), torch.from_numpy(coefs),
                                torch.from_numpy(b), (64, 64), upsample=upsample, binarize=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    binar = mask_ops.process_mask(torch.from_numpy(protos).permute(2, 0, 1), torch.from_numpy(coefs),
                                  torch.from_numpy(b), (64, 64), upsample=upsample)
    assert binar.dtype == torch.bool
    np.testing.assert_array_equal(binar.numpy(), got.numpy() > 0.5)


def test_crop_mask_matches_jax():
    rng = np.random.default_rng(3)
    masks = rng.uniform(0, 1, (5, 20, 24)).astype(np.float32)
    b = np.array([[0, 0, 24, 20], [2.5, 3.2, 10.1, 19.9], [-3, 4, 8, 30], [5, 5, 5, 9],
                  [23.5, 0.5, 30, 2]], np.float32)
    want = np.asarray(jax_mask_ops.crop_mask(jnp.asarray(masks), jnp.asarray(b)))
    got = mask_ops.crop_mask(torch.from_numpy(masks), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("img0", [(48, 80), (1080, 1920), (640, 480)])
def test_scale_boxes_matches_jax(img0):
    rng = np.random.default_rng(img0[0])
    xy = rng.uniform(-10, 600, (12, 2))
    b = np.concatenate([xy, xy + rng.uniform(1, 200, (12, 2))], 1).astype(np.float32)
    want = np.asarray(jax_boxes.scale_boxes((640, 640), jnp.asarray(b), img0))
    got = boxes.scale_boxes((640, 640), torch.from_numpy(b), img0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_box_iou_and_xywh2xyxy_match_jax():
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(0, 50, (7, 2)), rng.uniform(1, 30, (7, 2))], 1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 50, (9, 2)), rng.uniform(1, 30, (9, 2))], 1).astype(np.float32)
    ax, bx = (np.array(jax_boxes.xywh2xyxy(jnp.asarray(t))) for t in (a, b))
    np.testing.assert_allclose(boxes.xywh2xyxy(torch.from_numpy(a)).numpy(), ax, rtol=0, atol=1e-6)
    want = np.asarray(jax_boxes.box_iou(jnp.asarray(ax), jnp.asarray(bx)))
    got = boxes.box_iou(torch.from_numpy(ax), torch.from_numpy(bx))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_scale_image_close_to_cv2():
    """The port un-letterboxes masks in OpenCV's own float32 INTER_LINEAR
    arithmetic; the JAX package calls cv2.resize, which takes Intel IPP's
    (tests/test_torch_port_predict_io.py holds the two within 3e-6). They
    agree to 1e-4 on smooth masks."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (3, 8, 8)).astype(np.float32)
    masks = torch.nn.functional.interpolate(torch.from_numpy(base)[None], size=(64, 64),
                                            mode="bilinear", align_corners=False)[0]
    want = jax_mask_ops.scale_image((64, 64), masks.permute(1, 2, 0).numpy(), (48, 80))
    got = mask_ops.scale_image((64, 64), masks, (48, 80))
    assert got.shape == (3, 48, 80)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=0, atol=1e-4)
