"""DD3DDenseDepth (depth pretraining) in the port against the JAX package,
on the CPU in fp32, with dd3d_kitti_dla34's trunk under
MODEL.META_ARCHITECTURE = DD3DDenseDepth (FPN 64, a 1-conv tower, 128x128,
batch 2):

- `aligned_bilinear` against JAX's at every stride factor of P3-P7 (8 to
  128) and both location offsets: its linspace grid equal to JAX's bit for
  bit, the blend within 4 ulps of the largest value;
- the model's per-level full-resolution depth, focal-scaled from the
  inverse intrinsics, within 1e-5 of each level's largest magnitude (the
  maps reach ~125 and cross zero, so a relative bound a value means
  nothing there; f32 rounding through the trunk puts both sides ~3e-6
  apart), with the same seeded weights through `convert_flax_variables`;
- `dense_depth_losses` on the same inputs within 1e-6 relative, the
  valid-depth mask and the sqrt(2)^level decay included;
- one train step against JAX's `make_train_step` (compiled with the
  persistent cache off, as tests/test_torch_train.py): the losses within
  2e-4, every gradient and update of the port within 5e-3 of its own f64
  step per tensor, and JAX's and the port's as flat vectors within 1e-3 in
  L2 (tests/test_torch_train.py's bounds); TPU.PALLAS_STEM_DW on, so the
  stem's weight gradient runs its plain version here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dd3d_tpu.ops.color_jitter  # noqa: F401  (imported before a traced train step, see ROADMAP §3)
from dd3d_tpu.configs import get_experiment_cfg as jax_experiment
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.models.dense_depth import dense_depth_losses as jax_dense_depth_losses
from dd3d_tpu.ops.locations import aligned_bilinear as jax_aligned_bilinear
from dd3d_tpu.training.optim import build_optimizer as jax_build_optimizer
from dd3d_tpu.training.train_step import TrainState, make_train_step as jax_make_train_step
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.dense_depth import DD3DDenseDepth, dense_depth_losses
from dd3d_tpu_torch.ops.locations import _linspace_f32, aligned_bilinear
from dd3d_tpu_torch.training.synthetic import synthetic_batch
from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
from dd3d_tpu_torch.training.train_step import make_train_step
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_params, convert_flax_variables

from tests.test_torch_train import capture_grads, distances_from_oracle, f64_train_step
from tests.torch_port_util import seed_flax_variables, torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def small_cfg(get=get_experiment_cfg):
    """dd3d_kitti_dla34 as DD3DDenseDepth: FPN 64, a 1-conv tower, f32,
    lr 1.0 from step 0, the stem's weight gradient routed to the kernel."""
    cfg = get("dd3d_kitti_dla34")
    cfg.MODEL.META_ARCHITECTURE = "DD3DDenseDepth"
    cfg.MODEL.DEPTH_ON = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PALLAS_STEM_DW = True
    cfg.FE.FPN.OUT_CHANNELS = 64
    cfg.DD3D.FCOS3D.NUM_CONVS = 1
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = 1.0, 0
    return cfg


@pytest.mark.parametrize("factor", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("offset", ["none", "half"])
def test_aligned_bilinear_matches_jax(factor, offset):
    """The sample grid equal to jnp.linspace's bit for bit at each side of
    P3-P7 at 384x1280 and of this input; the blend within 4 ulps of the
    largest value (XLA:CPU fuses the four products and sums, with FMAs on
    some hosts, where the port rounds each step)."""
    for side in (3, 5, 48, 160, 24, 80, 12, 40, 6, 20, 10):
        want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, float(side), factor * side + 1))())
        np.testing.assert_array_equal(_linspace_f32(side, factor * side + 1).numpy(), want)
    x = np.random.RandomState(factor).randn(2, 3, 5, 1).astype(np.float32) * 10
    want = np.asarray(jax.jit(lambda a: jax_aligned_bilinear(a, factor, offset))(jnp.asarray(x)))
    got = aligned_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), factor, offset).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 3 * factor, 5 * factor, 1)
    assert np.abs(got - want).max() <= 2.0 ** -21 * np.abs(want).max()
    first = factor // 2 if offset == "half" else 0
    np.testing.assert_array_equal(got[:, first::factor, first::factor], x)  # the grid's own points: the input


@pytest.fixture(scope="module")
def case():
    cfg = small_cfg()
    jm = build_jax_model(small_cfg(jax_experiment))
    variables = seed_flax_variables(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False), 1)
    pm = build_model(cfg)
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    batch = synthetic_batch(np.random.RandomState(1), 2, 128, 128, max_gt=16, max_gt_per_image=6,
                            depth_density=0.3)
    batch["intrinsics"][1, :2] *= 1.2  # a second focal length
    return dict(cfg=cfg, jm=jm, variables=variables, pm=pm, batch=batch)


def test_forward_matches_jax(case):
    jm, variables, pm, batch = case["jm"], case["variables"], case["pm"], case["batch"]
    assert isinstance(pm, DD3DDenseDepth) and pm.strides == (8, 16, 32, 64, 128)
    inv_k = np.linalg.inv(batch["intrinsics"]).astype(np.float32)
    want = jax.jit(lambda v, x, k: jm.apply(v, x, inv_intrinsics=k, train=False))(
        variables, jnp.asarray(batch["image"]), jnp.asarray(inv_k))
    with torch.no_grad():
        got = pm(torch.from_numpy(batch["image"]), torch.from_numpy(inv_k))
    assert len(got) == len(want) == 5
    for lvl, (p, j) in enumerate(zip(got, want)):
        assert p.shape == j.shape == (2, 128, 128) and p.dtype == torch.float32
        want = np.asarray(j)
        assert np.abs(p.numpy() - want).max() <= 1e-5 * np.abs(want).max(), f"level {lvl}"


def test_losses_match_jax(case):
    rng = np.random.RandomState(2)
    preds = [(rng.rand(2, 128, 128) * 90).astype(np.float32) for _ in range(5)]
    gt = case["batch"]["depth"]
    assert (gt > 80).any() and ((gt > 0) & (gt < 80)).mean() > 0.2  # past MAX_DEPTH too: masked
    want = jax_dense_depth_losses([jnp.asarray(p) for p in preds], jnp.asarray(gt), beta=0.05)
    got = dense_depth_losses([torch.from_numpy(p) for p in preds], torch.from_numpy(gt), beta=0.05)
    assert list(got) == list(want) == [f"loss_dense_depth_lvl_{l}" for l in range(5)]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def train_case(case):
    cfg, jm, variables, pm, batch = (case[k] for k in ("cfg", "jm", "variables", "pm", "batch"))
    jcfg = small_cfg(jax_experiment)
    tx = optax.chain(capture_grads(), jax_build_optimizer(jcfg, variables["params"]))
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # compiled for this host, as test_torch_train.py
    try:
        new_state, metrics_j = jax.jit(jax_make_train_step(jcfg, jm))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    m64, grads64 = f64_train_step(cfg, before, batch)
    ts = create_train_state(cfg, pm, "cpu")
    metrics_p = make_train_step(cfg, ts.model, ts.optimizer)(to_device(batch, "cpu"))
    return dict(pm=pm, before=before, metrics_p={k: float(v) for k, v in metrics_p.items()},
                metrics_j={k: float(v) for k, v in metrics_j.items()},
                grads_j=convert_flax_params(new_state.opt_state[0], pm),
                params_j=convert_flax_params(new_state.params, pm), grads64=grads64,
                updates64={n: p.detach().numpy() - before[n].double().numpy() for n, p in m64.named_parameters()})


def test_train_step_losses_match(train_case):
    mp, mj = train_case["metrics_p"], train_case["metrics_j"]
    assert set(mp) == set(mj) and mp["loss_finite"] == 1.0
    assert {k for k in mp if k.startswith("loss_dense")} == {f"loss_dense_depth_lvl_{l}" for l in range(5)}
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=k)


PORT_BOUND = 5e-3  # per tensor, relative to its largest f64 magnitude (tests/test_torch_train.py)


def _assert_close(got, jax_side, oracle):
    for name, (err_port, _err_jax) in distances_from_oracle(got, jax_side, oracle).items():
        assert err_port <= PORT_BOUND, f"{name}: port {err_port:.3e} from its f64 step"
    flat_o = np.concatenate([oracle[n].ravel() for n in jax_side])
    flat_g = np.concatenate([got[n].ravel() for n in jax_side])
    flat_j = np.concatenate([w.ravel() for w in jax_side.values()])
    assert np.linalg.norm(flat_j - flat_o) <= 1e-3 * np.linalg.norm(flat_o), "JAX's step is not the oracle's"
    assert np.linalg.norm(flat_g - flat_j) <= 1e-3 * np.linalg.norm(flat_j)


def test_train_step_gradients_match(train_case):
    pm = train_case["pm"]
    grads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert all(np.abs(g).max() > 0 for n, g in grads.items() if "dense_depth" in n)
    _assert_close(grads, {n: g.numpy() for n, g in train_case["grads_j"].items()}, train_case["grads64"])


def test_train_step_updates_match(train_case):
    pm, before, params_j = train_case["pm"], train_case["before"], train_case["params_j"]
    names = [n for n, _ in pm.named_parameters()]
    _assert_close({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
                  {n: (params_j[n] - before[n]).numpy() for n in names}, train_case["updates64"])
