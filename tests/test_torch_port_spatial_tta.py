"""Test-time augmentation on a space mesh: `evaluate_segment(augment=True)` on
dp 1 x sp 2 gloo ranks (tests/torch_port_dist_worker.py, as
tests/test_torch_port_spatial.py runs them). The augmented forward runs
gathered, the whole frames on every space rank (its scales give heights the
bands need not divide), so each rank returns the one-process metrics and
JAX's one-device `evaluate_segment(augment=True)`'s, whose jit re-partitions
the rescaled frames itself. The primed TINY_SEG on two self-labelled batches
of 4, the last with 3 real frames; metrics within 1e-6 of the port's one
process and 1e-4 of JAX's (tests/test_torch_port_tta.py's bound).
"""

import numpy as np

from test_torch_port_eval import self_labelled_batches
from torch_port_common import TINY_NC, TINY_NM, TINY_SEG, port_model, primed_tiny
from torch_port_dist_worker import join_ranks, start_ranks
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu_torch.engine.validator import evaluate_segment


def test_augmented_evaluation_on_a_space_mesh_matches_one_process_and_jax(tmp_path):
    jm, v = primed_tiny()
    batches = self_labelled_batches(v, True, False)
    batches[-1]["n_valid"] = np.int32(3)
    kw = dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM, augment=True)
    handle = start_ranks({"kind": "eval_segment", "cfg": TINY_SEG,
                          "state_dict": port_model(v).state_dict(), "batches": batches,
                          "nc": TINY_NC, "kw": kw, "mesh2d": (1, 2)}, tmp_path, world=2)
    want, want_maps, _ = jax_evaluate_segment(jm, v, batches, TINY_NC, **kw)
    one, one_maps, _ = evaluate_segment(port_model(v), batches, TINY_NC, device="cpu", **kw)
    ranks = join_ranks(handle)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], np.asarray(one, np.float64), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["maps"], one_maps, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["mean"], np.asarray(want, np.float64), rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["maps"], want_maps, rtol=0, atol=1e-4)
    assert one[2] > 0.05 and one[6] > 0.05, one
