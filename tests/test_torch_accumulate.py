"""SOLVER.ACCUMULATE_GRAD_BATCHES = 2 in the port's train step
(training/optim.py, training/train_step.py) against JAX's step with
optax.MultiSteps (dd3d_tpu/training/optim.py:142-143), over 4 micro-batches
of the small model of tests/test_torch_train.py at 128x256, on the CPU in
f32:

- the losses of every micro-batch (rtol 2e-4, as the train-step test);
- the BN running statistics after the 4 micro-batches: they update on every
  micro-batch (2e-5 of the largest, as the train-step test);
- the parameters' change over the 2 applied updates: the port per tensor
  against its own step in f64, JAX against that step and against the port
  as flat vectors within 1e-3 (`assert_close_per_tensor`);
- the schedule advances on applied updates only: a linear warmup from 0 over
  4 counts gives the first update lr 0 and the second lr(1) = base / 4
  (lr(3) if it advanced on every micro-batch); the first update's momentum
  (the mean gradient of micro-batches 1-2) carries into the second.
With lr 0 for the first update every micro-batch's gradient is taken at the
starting weights. The micro-batches are one batch under 4 draws of the color
jitter: distinct gradients (a step that kept only the last micro-batch, or
summed them, lies far outside the bounds) that do not cancel in their mean.
At 128x256 the port's worst tensor lies 0.56 of its bound from f64 (a DLA
level4 conv) and the flat vectors 3.3e-4 (port-f64), 1.7e-4 (JAX-f64) and
3.6e-4 (port-JAX) apart. How far f32 lies from f64 depends on the inputs at
these random weights, more than in one step: at 128x128 other jitter draws
or other batches put the port's worst tensor 2.7-4.6 times its bound from
f64 (P7's conv weight, DLA level4-5 convs) and JAX 1.6e-4 to 4.5e-3 in flat
L2; the 128x256 canvas gives P5-P7 twice the values a channel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

# imported here, outside any trace: the JAX step imports it lazily, and a
# first import inside a jit trace leaves its module-level constant a tracer
# that the next traced step in this process trips over
import dd3d_tpu.ops.color_jitter  # noqa: F401
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.training.optim import build_optimizer as jax_build_optimizer
from dd3d_tpu.training.train_step import TrainState, make_train_step as jax_make_train_step
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.training.synthetic import synthetic_batch
from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
from dd3d_tpu_torch.training.train_step import make_train_step
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_params, convert_flax_variables
from tests.test_torch_train import assert_close_per_tensor, float_means_double, seeded_model, small_cfg
from tests.torch_port_util import jax_variables, torch_threads

MICRO_BATCHES = 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def accumulate_cfg():
    cfg = small_cfg()
    sol = cfg.SOLVER
    sol.ACCUMULATE_GRAD_BATCHES = 2
    sol.BASE_LR, sol.WARMUP_FACTOR, sol.WARMUP_ITERS, sol.WARMUP_METHOD = 1.0, 0.0, 4, "linear"
    return cfg


def f64_run(cfg, state_dict, batches):
    """The oracle: the port's steps in f64 (as tests/test_torch_train.py's
    f64_train_step); returns the model."""
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float64"
    model = build_model(cfg).double()
    model.load_state_dict(state_dict, strict=True)
    for m in (model.backbone.bottom_up.base_layer, *model.backbone.bottom_up.level0):
        m.weight_grad_plain = True
    ts = create_train_state(cfg, model, "cpu")
    step = make_train_step(cfg, ts.model, ts.optimizer)
    with float_means_double():
        for b in batches:
            step({k: v.double() if v.is_floating_point() else v for k, v in to_device(b, "cpu").items()})
    return model


@pytest.fixture(scope="module")
def case():
    cfg = accumulate_cfg()
    pm = seeded_model(cfg)
    jm = build_jax_model(cfg)
    variables = jax_variables(cfg, jm, {k: v.numpy() for k, v in pm.state_dict().items()})
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    # one batch of 2 at 128x256, under 4 draws of the color jitter that
    # follow it in its stream
    rng = np.random.RandomState(1)
    base = synthetic_batch(rng, 2, 128, 256, max_gt=16, max_gt_per_image=6)
    batches = [dict(base, color_jitter=rng.uniform(0.8, 1.2, (2, 3)).astype(np.float32))
               for _ in range(MICRO_BATCHES)]

    tx = jax_build_optimizer(cfg, variables["params"])
    assert isinstance(tx, optax.MultiSteps)
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    metrics_j = []
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # compiled for this host's CPU
    try:
        step_j = jax.jit(jax_make_train_step(cfg, jm))
        for b in batches:
            state, m = step_j(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics_j.append({k: float(v) for k, v in m.items()})
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)

    before = {k: v.clone() for k, v in pm.state_dict().items()}
    m64 = f64_run(cfg, before, batches)
    ts = create_train_state(cfg, pm, "cpu")
    step = make_train_step(cfg, ts.model, ts.optimizer)
    metrics_p = [{k: float(v) for k, v in step(to_device(b, "cpu")).items()} for b in batches]
    names = [n for n, _ in pm.named_parameters()]
    params_j = convert_flax_params(state.params, pm)
    return dict(
        ts=ts, metrics_p=metrics_p, metrics_j=metrics_j, before=before,
        state_j=convert_flax_variables({"params": state.params, "batch_stats": state.batch_stats}, pm),
        updates_p={n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
        updates_j={n: (params_j[n] - before[n]).numpy() for n in names},
        updates64={n: p.detach().numpy() - before[n].double().numpy() for n, p in m64.named_parameters()},
    )


def test_accumulated_losses_match(case):
    assert len(case["metrics_p"]) == len(case["metrics_j"]) == MICRO_BATCHES
    for i, (mp, mj) in enumerate(zip(case["metrics_p"], case["metrics_j"])):
        assert mp["loss_finite"] == 1.0
        for k in mj:
            if k.startswith("loss_") or k == "total_loss":
                np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=f"micro-batch {i + 1} {k}")


def test_accumulated_updates_match(case):
    ts = case["ts"]
    assert ts.optimizer.count == 2 and ts.optimizer.mini_step == 0
    moved = sum(np.abs(u).max() > 0 for u in case["updates_j"].values())
    assert moved > 0.9 * len(case["updates_j"])
    assert_close_per_tensor(case["updates_p"], case["updates_j"], case["updates64"])


def test_accumulated_bn_statistics_match(case):
    pm, before, state_j = case["ts"].model, case["before"], case["state_j"]
    moved = 0
    for key, now in pm.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            want = state_j[key].numpy()
            np.testing.assert_allclose(now.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max(), err_msg=key)
            moved += not torch.equal(now, before[key])
    assert moved == 2 * 5 * 2  # both stats of the 5 per-level BNs of the 2 FCOS2D tower layers


def test_lr_of_the_applied_updates():
    """lr 0 at the first update, lr(1) = base / 4 at the second; the
    micro-batch count and the accumulated gradients ride in the optimizer's
    state dict between two updates."""
    from dd3d_tpu_torch.training.optim import Optimizer

    cfg = accumulate_cfg()
    opt = Optimizer(cfg, seeded_model(cfg))
    assert opt.accumulate == 2 and opt.schedule(0) == 0.0 and opt.schedule(1) == 0.25
    opt.mini_step = 1
    for p in opt.params:
        p.grad = torch.ones_like(p)
    state = opt.state_dict()
    assert state["mini_step"] == 1 and len(state["acc_grads"]) == len(opt.params)
    for p in opt.params:
        p.grad = None
    opt.load_state_dict(state)
    assert opt.mini_step == 1 and all(torch.equal(p.grad, torch.ones_like(p)) for p in opt.params)
