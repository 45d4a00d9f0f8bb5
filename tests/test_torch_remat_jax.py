"""TPU.REMAT: the port's train step (dd3d_tpu_torch/training/remat.py)
against JAX's (dd3d_tpu/training/train_step.py, jax.checkpoint) under
"full" and "dots_saveable", one JAX compile each, at tests/test_torch_train.py's
small model and batch: the losses, and the gradients, updates and BN running
statistics with that file's bounds from the port's step in f64. (The port's
policies against its own "none" step: tests/test_torch_remat.py.)
"""
import numpy as np
import pytest

import dd3d_tpu.ops.color_jitter  # noqa: F401  (imported before a second JAX train step is traced)
from dd3d_tpu_torch.models.layers import FoldableBatchNorm
from tests.test_torch_train import assert_close_per_tensor, make_train_step_case, small_cfg
from tests.torch_port_util import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


@pytest.fixture(scope="module", params=["full", "dots_saveable"])
def jax_remat_case(request):
    cfg = small_cfg()
    cfg.TPU.REMAT = request.param
    return make_train_step_case(cfg)


def test_remat_step_matches_jax(jax_remat_case):
    """Losses, gradients, updates and the running statistics of the two
    REMAT steps, as tests/test_torch_train.py holds the plain steps."""
    case = jax_remat_case
    mp, mj = case["metrics_p"], case["metrics_j"]
    assert set(mp) == set(mj) and mp["loss_finite"] == 1.0
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=k)
    pm, before, params_j = case["pm"], case["before"], case["params_j"]
    assert_close_per_tensor({n: p.grad.numpy() for n, p in pm.named_parameters()},
                            {n: g.numpy() for n, g in case["grads_j"].items()}, case["grads64"])
    names = [n for n, _ in pm.named_parameters()]
    assert_close_per_tensor({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
                            {n: (params_j[n] - before[n]).numpy() for n in names}, case["updates64"])
    for name, module in pm.named_modules():
        if isinstance(module, FoldableBatchNorm):
            for buf in ("running_mean", "running_var"):
                key = f"{name}.{buf}"
                want = case["state_j"][key].numpy()
                np.testing.assert_allclose(pm.get_buffer(key).numpy(), want, rtol=0,
                                           atol=2e-5 * np.abs(want).max(), err_msg=key)
