"""deepseek-v2-lite's train step from the port's `launch.steps` against
the JAX package's at world 1 on the CPU (its smoke config, 2 x 16 tokens):
the loss, the params and the gradient moments after one step within
`_torch_steps.STEP_TOL` times the largest magnitude of JAX's, unplaced and
placed as DTensors over a world-1 gloo group (the MoE layer's DTensor
route, `models.moe._moe_layer_dtensor`, on its dense path there).  JAX's
step is computed once for both.
"""
import pytest
import torch

import _torch_steps
from _torch_steps import world  # noqa: F401  (a fixture of the test below)

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_train():
    return _torch_steps.jax_step(ARCH, "train")


@pytest.mark.parametrize("world", ["plain", "dtensor"], indirect=True)
def test_moe_train_step_at_world_one_equals_jax(world, jax_train):
    _torch_steps.check_world_one(ARCH, "train", world, jax_train)
