"""The controlled semantic golden regime of tests/test_semantic_golden.py
(30 epochs, bs 4, --nbs 4 --no-ema --no-augment, the golden hyp, dice, seed
3, the synthetic scene of 24 frames at 96 px, the host route) through JAX's
root semantic/train.py and the port's semantic.train on the CPU. Both start
from JAX's initial weights (the port's models/flax_init.py), so their
results.csv can be held epoch by epoch.

resnet50 measures the spread of two float32 implementations of one trainer:
its runs part from epoch 0 (train losses up to ~0.03 apart on the way) and
meet again at the plateau. yolov8_seg, whose JAX golden (0.3510) the port
missed (ROADMAP §C, C3), must track JAX more closely than that: its largest
train-loss gap at most resnet50's, its last epoch's mIoU within 0.01 of
JAX's. Not its best mIoU: JAX's golden is one epoch's spike of the val
argmax (epoch 13 of 30 read 0.3510 between 0.3109 and 0.3117 on an 8-core
CPU, in a run whose train losses stood within 0.0018 of the port's
throughout). Marked slow, as JAX's goldens are (~8 min on an 8-core CPU);
run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_semantic_golden.py -m slow -s
"""

import importlib.util
import json
import sys

import numpy as np
import pytest

from torch_port_common import ROOT

pytest.importorskip("cv2")

HYP = dict(lr0=0.05, lrf=0.2, momentum=0.9, weight_decay=5e-4, warmup_epochs=1.0,
           warmup_momentum=0.8, warmup_bias_lr=0.1, ema_decay=0.95, ema_tau=50.0)


def _args(project, name):
    return ["--imgsz", "96", "--batch-size", "4", "--epochs", "30", "--loss", "dice",
            "--project", str(project), "--name", name, "--seed", "3",
            "--nbs", "4", "--no-ema", "--no-augment"]


def _both(cfg, root):
    """results.csv of JAX's and of the port's run of `cfg` under `root`, and
    each epoch's largest train-loss gap between them."""
    import yaml

    from yolo_dual_tpu.data.tools import write_synthetic_camvid_scene as jax_scene
    from yolo_dual_tpu_torch.data.tools import write_synthetic_camvid_scene
    from yolo_dual_tpu_torch.semantic import train as port_train
    spec = importlib.util.spec_from_file_location("sem_train_golden_vs_port",
                                                  ROOT / "semantic" / "train.py")
    jax_train = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = jax_train
    spec.loader.exec_module(jax_train)
    root.mkdir(parents=True)
    (root / "hyp.yaml").write_text(yaml.safe_dump(HYP))
    (root / "hyp.json").write_text(json.dumps(HYP))
    img, js = jax_scene(root / "jax_scene", 24, 96)
    jax_train.train(jax_train.parse_opt(
        ["--cfg", f"{cfg}.yaml", "--img-dir", str(img), "--json-dir", str(js),
         "--hyp", str(root / "hyp.yaml")] + _args(root, "jax")))
    img, js = write_synthetic_camvid_scene(root / "port_scene")
    port_train.main(["--cfg", f"{cfg}.json", "--img-dir", str(img), "--json-dir", str(js),
                     "--hyp", str(root / "hyp.json"), "--device", "cpu"] + _args(root, "port"))
    want, got = (np.loadtxt(root / side / "results.csv", delimiter=",", skiprows=1)
                 for side in ("jax", "port"))
    assert got.shape == want.shape == (30, 7)
    gap = np.abs(got[:, 1:4] - want[:, 1:4]).max(1)
    for e, (w, g, d) in enumerate(zip(want, got, gap)):
        print(f"{cfg} epoch {e}: JAX loss {w[1]:.4f} mIoU {w[4]:.4f} | port loss {g[1]:.4f} "
              f"mIoU {g[4]:.4f} | loss gap {d:.4f}")
    print(f"{cfg}: best mIoU JAX {want[:, 4].max():.4f} port {got[:, 4].max():.4f}, "
          f"largest train-loss gap {gap.max():.4f} (epoch {gap.argmax()})")
    return want, got, gap


@pytest.mark.slow
def test_yolov8_seg_tracks_jax_within_the_resnet50_spread(tmp_path):
    _, _, spread = _both("resnet50", tmp_path / "resnet50")
    want, got, gap = _both("yolov8_seg", tmp_path / "yolov8_seg")
    assert gap.max() <= spread.max()
    assert abs(got[-1, 4] - want[-1, 4]) <= 0.01
