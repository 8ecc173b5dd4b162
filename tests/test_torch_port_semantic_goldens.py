"""The nine controlled semantic goldens of tests/test_semantic_golden.py
(GOLDENS_CONTROLLED) as runs of the port's semantic.train on the CPU, in the
regime of tests/test_torch_port_semantic_golden.py: 30 epochs, bs 4, --nbs 4
--no-ema --no-augment, the golden hyp, dice, seed 3, the synthetic scene of
24 frames at 96 px, the host route, from JAX's initial weights. Each run's
best mIoU holds at its golden less SLACK, as JAX's own controlled goldens
do. Marked slow, as JAX's are (1-5 min a config on an 8-core CPU):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_semantic_goldens.py -m slow -s

The runs are float32 and resnet50's is chaotic: the intra-op thread count
sets the summation order, and at 2 threads resnet50 ends on another plateau
(best mIoU 0.4591 against 0.9246 at 8), as default-algorithm runs on the
card do (ROADMAP §C). So each run pins torch's intra-op threads to
GOLDEN_THREADS, the count the goldens were reached at, whatever the
launcher (one process, or xdist workers, which tests/torch_port_common.py
gives a share of the cores); the CPU's instruction set still counts.
"""

import json

import pytest
import torch

from test_semantic_golden import GOLDENS_CONTROLLED, SLACK
from test_torch_port_semantic_golden import HYP, _args

pytest.importorskip("cv2")

GOLDEN_THREADS = 8


@pytest.fixture
def golden_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(GOLDEN_THREADS)
    yield
    torch.set_num_threads(before)


@pytest.mark.slow
@pytest.mark.parametrize("cfg", sorted(GOLDENS_CONTROLLED))
def test_port_semantic_golden_controlled(cfg, tmp_path, golden_threads):
    from yolo_dual_tpu_torch.data.tools import write_synthetic_camvid_scene
    from yolo_dual_tpu_torch.semantic import train
    (tmp_path / "hyp.json").write_text(json.dumps(HYP))
    img, js = write_synthetic_camvid_scene(tmp_path / "scene")
    name = cfg.removesuffix(".yaml")
    miou = train.main(["--cfg", f"{name}.json", "--img-dir", str(img), "--json-dir", str(js),
                       "--hyp", str(tmp_path / "hyp.json"), "--device", "cpu"]
                      + _args(tmp_path, name))
    print(f"{name}: port best mIoU {miou:.4f}, golden {GOLDENS_CONTROLLED[cfg]:.4f}")
    assert miou >= GOLDENS_CONTROLLED[cfg] - SLACK, f"{cfg}: controlled mIoU {miou:.4f} below golden"
