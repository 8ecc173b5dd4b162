"""`semantic.val` and `semantic.train` of the port on the narrow yolov5_seg
(C3_DCN rows of DCNv2 blocks, every width / 16, BatchNorm calibrated on the
frames, DCNv2 offset heads spread as in test_torch_port_semantic_yolo.py)
against JAX's `evaluate_semantic` and root `semantic/train.py` on the CPU, from
the same weights: an orbax checkpoint for JAX (its own `.pt` import reads no
DCNv2 leaf) and the port's `.pt` state_dict, on 10 seeded 72x96 frames with
JSON masks (PNG for JAX, `.npy` for the port)."""

import importlib.util
import json
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import ROOT, SEM_NC, narrow_calibrated, write_json_set
from yolo_dual_tpu.data.json_dataset import JSONSegmentDataset as JaxJSONDataset
from yolo_dual_tpu.data.loader import Loader as JaxLoader
from yolo_dual_tpu.engine import evaluate_semantic as jax_evaluate_semantic
from yolo_dual_tpu.losses import semantic as jax_loss
from yolo_dual_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import SemanticSegModel
from yolo_dual_tpu_torch.semantic import train as train_cli
from yolo_dual_tpu_torch.semantic import val as val_cli

cv2 = pytest.importorskip("cv2")
IMGSZ = 64




@pytest.fixture(scope="module")
def yolo_set(tmp_path_factory):
    """10 seeded 72x96 frames with JSON masks (PNG for JAX, `.npy` for the
    port), the narrow yolov5_seg as YAML and JSON, its calibrated weights as
    an orbax checkpoint and as a `.pt` state_dict."""
    from yolo_dual_tpu_torch.data import json_dataset
    root = write_json_set(tmp_path_factory.mktemp("sem_yolo"), 10, (72, 96), seed=6)
    ds = json_dataset.JSONSegmentDataset(root / "port" / "images", root / "json", img_size=IMGSZ)
    d, jm, v = narrow_calibrated("yolov5_seg", 16, 12, np.stack([ds[i]["image"] for i in range(8)]))
    (root / "narrow.yaml").write_text(yaml.safe_dump(d))
    (root / "narrow.json").write_text(json.dumps(d))
    jax_save_checkpoint(root / "jax_weights", {"variables": v})
    torch.save(state_dict_from_flax(v), root / "port_weights.pt")
    return root, jm, v


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host", "device"])
def test_val_cli_matches_jax(yolo_set, device_preprocess):
    """semantic.val.run against JAX's evaluate_semantic on JAX's loader, same
    weights: mIoU and per-class IoU within 1e-4, the val loss 1e-5 relative
    (the calibrated narrow net has no argmax pixel within 1e-3 of a tie that
    flips here)."""
    root, jm, v = yolo_set
    kw = dict(img_size=IMGSZ, num_classes=SEM_NC, device_preprocess=device_preprocess)
    jloader = JaxLoader(JaxJSONDataset(root / "jax" / "images", root / "json", **kw),
                        batch_size=4, prefetch=0)
    want, want_iou, _ = jax_evaluate_semantic(jm, v, jloader, SEM_NC, ignore_index=11,
                                              loss_fn=jax_loss.SemanticSegLoss(SEM_NC))
    got, got_iou, (ms,) = val_cli.run(
        weights=str(root / "port_weights.pt"), cfg=str(root / "narrow.json"),
        img_dir=str(root / "port" / "images"), json_dir=str(root / "json"), imgsz=IMGSZ,
        batch_size=4, device="cpu", device_preprocess=device_preprocess)
    assert ms > 0 and 0 < want[0] < 1
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_iou, want_iou, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def _jax_train_cli():
    spec = importlib.util.spec_from_file_location("sem_train_yolo_vs_port",
                                                  str(ROOT / "semantic" / "train.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_matches_jax(yolo_set, tmp_path):
    """python -m yolo_dual_tpu_torch.semantic.train against root
    semantic/train.py, 2 epochs at bs 4, --nbs 8 (accumulate 2), host
    augmentation, from the same weights: the loss columns of results.csv 1e-5
    relative, mIoU and fitness 1e-4, the val loss 1e-5 relative."""
    root, _, _ = yolo_set
    args = ["--imgsz", str(IMGSZ), "--batch-size", "4", "--epochs", "2", "--nbs", "8",
            "--seed", "1", "--json-dir", str(root / "json"), "--name", "exp"]
    jax_train = _jax_train_cli()
    jax_train.train(jax_train.parse_opt(args + [
        "--cfg", str(root / "narrow.yaml"), "--img-dir", str(root / "jax" / "images"),
        "--weights", str(root / "jax_weights"), "--project", str(tmp_path / "jax")]))
    train_cli.main(args + ["--cfg", str(root / "narrow.json"),
                           "--img-dir", str(root / "port" / "images"),
                           "--weights", str(root / "port_weights.pt"), "--device", "cpu",
                           "--project", str(tmp_path / "port")])
    want, got = (np.loadtxt(tmp_path / side / "exp" / "results.csv", delimiter=",", skiprows=1,
                            ndmin=2) for side in ("jax", "port"))
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], rtol=1e-5)
    np.testing.assert_allclose(got[:, [4, 6]], want[:, [4, 6]], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5)
    last = train_cli.load_checkpoint(tmp_path / "port" / "exp" / "last.pt")
    m = SemanticSegModel(str(root / "narrow.json"), device="cpu")
    m.load_state_dict(last["model"], strict=True)
