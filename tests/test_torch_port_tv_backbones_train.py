"""The port's torchvision-family stages in train mode against the JAX
package's (the eval half and the helpers: tests/test_torch_port_tv_backbones.py),
on the same seeded weights, each stage on JAX's output of the stage before,
a batch of 2 images of 65 px.

The output and every BatchNorm's updated running statistics of the port run
in float64 stand within 1e-9 of their largest magnitude of JAX's apply in
float64 (torch_port_common.jax_train_float64). The float32 runs of either
package stand ~1e-5 from that reference after the 15 blocks of
efficientnet_v2_s3 (JAX's own 1.3e-5, the port's 9e-6, CPU), so the float64
runs hold the train-mode arithmetic (flax's biased running variance, the
families' momenta and eps, LayerNorm) to the last digits. JAX's float64
grouped convolutions are slow on the CPU (~25 s for efficientnet_v2_s): the
train half is a file of its own, so --dist loadfile spreads the two.
"""

import numpy as np
import pytest
import torch

from test_torch_port_tv_backbones import FAMILIES, assert_close, nhwc, run_chain, to_nchw
from torch_port_common import jax_train_float64
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax

TOL_F64 = 1e-9  # of the largest magnitude


@pytest.mark.parametrize("family", FAMILIES)
def test_stages_match_jax_train(family):
    def port_stage(port, x):
        with torch.no_grad():
            return nhwc(port.double().train()(to_nchw(x).double()))
    x = np.random.default_rng(65).standard_normal((2, 65, 65, 3)).astype(np.float32)
    for name, want, upd, got, port in run_chain(
            family, x, lambda jm, v, x: jax_train_float64(jm, v, x, jit=True), port_stage):
        assert_close(got, want, f"{name} output", TOL_F64)
        sd = port.state_dict()
        for k, w in state_dict_from_flax({"batch_stats": upd}).items():
            if not k.endswith("num_batches_tracked"):
                assert_close(sd[k].numpy(), w.numpy(), f"{name} {k}", TOL_F64)
