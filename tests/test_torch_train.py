"""The port's train step (dd3d_tpu_torch/training/) against the JAX package's
(dd3d_tpu/training/), on the CPU in f32:

- train-mode BN in a head tower: outputs and running statistics after two
  steps, per level, down to P7's 2 values a channel, which pins the biased
  fast variance and the 0.9 momentum;
- the weight-decay mask (the same excluded set as JAX's `_wd_mask`), the
  schedule, and SGD against `fused_sgd` over 3 steps, plain, Nesterov, and
  clipped by value and by norm;
- one whole train step, DLA-34 trunk + FPN 64 + 1-conv towers, 128x128,
  batch 2, color jitter, against `make_train_step`: losses, gradients by
  port name, the update of every parameter, and the BN statistics;
- checkpoint save -> resume -> continue against an uninterrupted run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from dd3d_tpu.configs import get_experiment_cfg
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.models import layers as jl
from dd3d_tpu.training.optim import _wd_mask, build_optimizer as jax_build_optimizer, warmup_multistep_schedule
from dd3d_tpu.training.train_step import TrainState, make_train_step as jax_make_train_step
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.layers import FoldableBatchNorm, FrozenBatchNorm, TowerConv
from dd3d_tpu_torch.training import optim as popt
from dd3d_tpu_torch.training.checkpoint import CheckpointManager
from dd3d_tpu_torch.training.synthetic import seed_norm_statistics, synthetic_batch
from dd3d_tpu_torch.training.train_loop import create_train_state, to_device, train
from dd3d_tpu_torch.training.train_step import make_train_step
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_params, convert_flax_variables, flax_param_paths

from tests.torch_port_util import jax_variables, torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def small_cfg():
    """dd3d_kitti_dla34 cut to a CPU test: FPN 64, 1-conv towers, f32, the
    stem's weight gradient routed to the kernel (its plain version here)."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PALLAS_STEM_DW = True
    cfg.FE.FPN.OUT_CHANNELS = 64
    cfg.DD3D.FCOS2D.NUM_CLS_CONVS = cfg.DD3D.FCOS2D.NUM_BOX_CONVS = cfg.DD3D.FCOS3D.NUM_CONVS = 1
    return cfg


def seeded_model(cfg, seed=0):
    """He-initialized convs (from the seed) and random norm statistics."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    return seed_norm_statistics(model, torch.Generator().manual_seed(seed + 1))


# --- train-mode BN -----------------------------------------------------------

class JaxTower(nn.Module):
    """One FCOS2D tower layer as fcos2d.py:140-149 applies it."""

    channels: int
    num_levels: int

    @nn.compact
    def __call__(self, xs, train):
        conv = jl.FoldableConv(self.channels, kernel_size=3, dtype=jnp.float32, name="conv")
        norm = jl.PerLevelNorms(self.num_levels, self.channels, "BN", dtype=jnp.float32, name="norm")
        outs = []
        for l, x in enumerate(xs):
            fold = norm(None, l, train, fold_query=True)
            outs.append(nn.relu(conv(x, *fold) if fold is not None else norm(conv(x), l, train)))
        return outs


def test_train_mode_bn_matches_jax():
    """Two train steps of a tower over P3..P7 of a 128x128 batch of 2 (P7 is
    1x1: two values a channel, where the unbiased variance would be twice
    the biased one), then an eval forward on the updated running stats."""
    c, shapes = 8, [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    rng = np.random.RandomState(0)
    steps = [[rng.randn(2, h, w, c).astype(np.float32) * 2 + 0.5 for h, w in shapes] for _ in range(2)]
    jt = JaxTower(c, len(shapes))
    v = jt.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in steps[0]], False)
    params = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3 + (a != 0) * 1.0,
                                    v["params"])
    stats = jax.tree_util.tree_map(lambda a: rng.rand(*a.shape).astype(np.float32) + 0.5, v["batch_stats"])

    pt = TowerConv(c, len(shapes), "BN")
    with torch.no_grad():
        pt.weight.copy_(torch.from_numpy(np.array(params["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        for l, norm in enumerate(pt.norm):
            norm.weight.copy_(torch.from_numpy(np.array(params["norm"][f"norm{l}"]["scale"])))
            norm.bias.copy_(torch.from_numpy(np.array(params["norm"][f"norm{l}"]["bias"])))
            norm.running_mean.copy_(torch.from_numpy(np.array(stats["norm"][f"norm{l}"]["mean"])))
            norm.running_var.copy_(torch.from_numpy(np.array(stats["norm"][f"norm{l}"]["var"])))
    pt.train()
    for xs in steps:
        outs_j, new = jt.apply({"params": params, "batch_stats": stats}, [jnp.asarray(x) for x in xs], True,
                               mutable=["batch_stats"])
        stats = new["batch_stats"]
        for l, x in enumerate(xs):
            out_p = pt(torch.from_numpy(x).permute(0, 3, 1, 2), l)
            np.testing.assert_allclose(out_p.detach().permute(0, 2, 3, 1).numpy(), np.asarray(outs_j[l]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"level {l}")
        for l, norm in enumerate(pt.norm):
            for buf, key in (("running_mean", "mean"), ("running_var", "var")):
                # 2e-5: E[x^2] - E[x]^2 cancels about 1 digit of the f32 sums
                np.testing.assert_allclose(getattr(norm, buf).numpy(), np.asarray(stats["norm"][f"norm{l}"][key]),
                                           rtol=2e-5, atol=1e-6, err_msg=f"level {l} {buf}")
    pt.eval()
    outs_j = jt.apply({"params": params, "batch_stats": stats}, [jnp.asarray(x) for x in steps[1]], False)
    with torch.no_grad():
        for l, x in enumerate(steps[1]):
            np.testing.assert_allclose(pt(torch.from_numpy(x).permute(0, 3, 1, 2), l).permute(0, 2, 3, 1).numpy(),
                                       np.asarray(outs_j[l]), rtol=1e-5, atol=1e-5)


# --- optimizer ---------------------------------------------------------------

def test_schedule_matches_jax():
    s = popt.warmup_multistep_schedule(0.002, [100, 200], 0.1, 1e-4, 10)
    assert s(0) == pytest.approx(0.002 * 1e-4)
    assert s(10) == pytest.approx(0.002)
    assert s(150) == pytest.approx(0.0002)
    assert s(250) == pytest.approx(0.00002)
    sj = warmup_multistep_schedule(0.002, [100, 200], 0.1, 1e-4, 10)
    for count in (0, 1, 5, 9, 10, 11, 99, 100, 101, 199, 200, 1000):
        assert s(count) == pytest.approx(float(sj(count)), rel=1e-6)


@pytest.fixture(scope="module")
def kitti_params():
    """(port model, JAX params) of dd3d_kitti_dla34 at full width."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    pm = build_model(cfg)
    jm = build_jax_model(cfg)
    return pm, jax_variables(cfg, jm, {k: v.numpy() for k, v in pm.state_dict().items()})["params"]


def test_weight_decay_mask_matches_jax(kitti_params):
    pm, params = kitti_params
    flat = {"/".join(k): bool(v) for k, v in jax.tree_util.tree_leaves_with_path(_wd_mask(params, True))
            for k in [tuple(str(p.key) for p in k)]}
    paths = flax_param_paths(pm)
    mask = popt.weight_decay_mask(pm, True)
    assert {"/".join(p) for p in paths.values()} == set(flat)
    assert {n for n, m in mask.items() if not m} == {n for n, p in paths.items() if not flat["/".join(p)]}
    excluded = [n for n, m in mask.items() if not m]
    assert len(excluded) == 2 * 5 * 8  # scale and bias of the 5 per-level BNs of the 8 FCOS2D tower layers
    assert all(popt.weight_decay_mask(pm, False).values())


@pytest.mark.parametrize("variant", ["plain", "nesterov", "clip_value", "clip_norm"])
def test_sgd_matches_fused_sgd(variant):
    """3 steps on the small model's parameters with random gradients, across
    the end of warmup; tolerance 1e-6 absolute (the lr is f32 in JAX and a
    double here)."""
    cfg = small_cfg()
    sol = cfg.SOLVER
    sol.BASE_LR, sol.STEPS, sol.WARMUP_ITERS = 0.02, [2], 1
    sol.NESTEROV = variant == "nesterov"
    sol.CLIP_GRADIENTS.ENABLED = variant.startswith("clip")
    sol.CLIP_GRADIENTS.CLIP_TYPE = "value" if variant == "clip_value" else "norm"
    sol.CLIP_GRADIENTS.CLIP_VALUE = 0.05 if variant == "clip_value" else 3.0
    pm = seeded_model(cfg)
    params = jax_variables(cfg, build_jax_model(cfg), {k: v.numpy() for k, v in pm.state_dict().items()})["params"]
    tx = jax_build_optimizer(cfg, params)
    opt_state = tx.init(params)
    opt = popt.Optimizer(cfg, pm)
    rng = np.random.RandomState(5)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in convert_flax_params(grads, pm).items():
            pm.get_parameter(name).grad = g
        opt.step()
    want = convert_flax_params(params, pm)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    assert opt.count == 3


# --- one whole train step --------------------------------------------------------

def capture_grads():
    """An optax transform that keeps the gradients it is given in its state."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def train_step_case():
    cfg = small_cfg()
    # lr 1.0 from step 0: updates far above the rounding of f32 parameters
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = 1.0, 0
    pm = seeded_model(cfg)
    jm = build_jax_model(cfg)
    variables = jax_variables(cfg, jm, {k: v.numpy() for k, v in pm.state_dict().items()})
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    batch = synthetic_batch(np.random.RandomState(1), 2, 128, 128, max_gt=16, max_gt_per_image=6)

    tx = optax.chain(capture_grads(), jax_build_optimizer(cfg, variables["params"]))
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    new_state, metrics_j = jax.jit(jax_make_train_step(cfg, jm))(state, {k: jnp.asarray(v) for k, v in batch.items()})

    before = {k: v.clone() for k, v in pm.state_dict().items()}
    ts = create_train_state(cfg, pm, "cpu")
    metrics_p = make_train_step(cfg, ts.model, ts.optimizer)(to_device(batch, "cpu"))
    return dict(
        pm=pm, before=before, metrics_p={k: float(v) for k, v in metrics_p.items()},
        metrics_j={k: float(v) for k, v in metrics_j.items()},
        grads_j=convert_flax_params(new_state.opt_state[0], pm),
        params_j=convert_flax_params(new_state.params, pm),
        state_j=convert_flax_variables({"params": new_state.params, "batch_stats": new_state.batch_stats}, pm),
    )


def test_train_step_losses_match(train_step_case):
    mp, mj = train_step_case["metrics_p"], train_step_case["metrics_j"]
    assert set(mp) == set(mj)
    assert mp["loss_finite"] == 1.0
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=k)


def assert_close_per_tensor(got, want):
    """Each tensor within 1e-2 of its largest magnitude (3e-2 for P6/P7),
    and the flat vector within 1e-3 in L2. Measured at 128x128, batch 2:
    worst 7.2e-3 (level2.tree1.conv1), 2.5e-2 on P7's conv, flat ~1e-4.
    Both sides are f32 through ~40 convs, ReLUs and train-mode BN, summed
    in other orders; P7 is 1x1 there, so each FCOS2D tower BN normalizes
    two values a channel, which amplifies rounding into the P6/P7 weights.
    A tensor's scale is floored at 1e-6 of the largest value of all: the
    P7 bias gradient is zero up to rounding (2e-7), as train-mode BN
    cancels a uniform shift."""
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6 * top)
        tol = 3e-2 if name.startswith("backbone.top_block.") else 1e-2
        np.testing.assert_allclose(got[name] / scale, w / scale, atol=tol, err_msg=name)
    flat_g = np.concatenate([got[n].ravel() for n in want])
    flat_w = np.concatenate([w.ravel() for w in want.values()])
    assert np.linalg.norm(flat_g - flat_w) <= 1e-3 * np.linalg.norm(flat_w)


def test_train_step_gradients_match(train_step_case):
    pm, grads_j = train_step_case["pm"], train_step_case["grads_j"]
    assert_close_per_tensor({n: p.grad.numpy() for n, p in pm.named_parameters()},
                            {n: g.numpy() for n, g in grads_j.items()})


def test_train_step_updates_match(train_step_case):
    """The update of every parameter (new - old), as the gradients, and the
    BN running statistics: the live ones moved as JAX's, FrozenBN never."""
    pm, before, params_j, state_j = (train_step_case[k] for k in ("pm", "before", "params_j", "state_j"))
    names = [n for n, _ in pm.named_parameters()]
    want = {n: (params_j[n] - before[n]).numpy() for n in names}
    # unmoved: P7's bias (a gradient zero up to rounding) and the box-tower
    # BNs of the levels without positives (exactly zero gradients)
    assert sum(np.abs(w).max() > 0 for w in want.values()) > 0.9 * len(want)
    assert_close_per_tensor({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names}, want)
    moved = 0
    for name, module in pm.named_modules():
        if isinstance(module, (FoldableBatchNorm, FrozenBatchNorm)):
            for buf in ("running_mean", "running_var"):
                key = f"{name}.{buf}"
                now = pm.get_buffer(key)
                want = state_j[key].numpy()  # 2e-5 of the largest: the sums of the batch statistics
                np.testing.assert_allclose(now.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max(), err_msg=key)
                if isinstance(module, FrozenBatchNorm):
                    assert torch.equal(now, before[key]), key
                else:
                    moved += not torch.equal(now, before[key])
    assert moved == 2 * 5 * 2  # both stats of the 5 per-level BNs of the 2 FCOS2D tower layers


# --- checkpoints -----------------------------------------------------------------

def test_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    cfg = small_cfg()
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    rng = np.random.RandomState(2)
    batches = [synthetic_batch(rng, 1, 128, 128, max_gt=8, max_gt_per_image=4) for _ in range(3)]

    straight = train(cfg, batches, model=seeded_model(cfg), device="cpu", max_iter=3)
    first = train(cfg, batches[:2], model=seeded_model(cfg), device="cpu", max_iter=2, output_dir=str(tmp_path))
    assert first.step == 2 and CheckpointManager(tmp_path / "ckpt").steps() == [2]
    resumed = train(cfg, batches[2:], model=seeded_model(cfg, seed=9), device="cpu", max_iter=3,
                    output_dir=str(tmp_path))
    assert resumed.step == 3 and resumed.optimizer.count == 3
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert CheckpointManager(tmp_path / "ckpt").steps() == [2, 3]


def test_checkpoint_manager_keeps_the_last_n(tmp_path):
    model = torch.nn.Linear(2, 2)
    opt = popt.Optimizer.__new__(popt.Optimizer)
    opt.sgd, opt.count = torch.optim.SGD(model.parameters(), lr=0.1), 0
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, model, opt)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore(model, opt) == 3 and mgr.restore(model, opt, step=2) == 2


def test_unported_training_options_raise():
    cfg = small_cfg()
    model = build_model(cfg)
    cfg.TPU.REMAT = "full"
    with pytest.raises(NotImplementedError, match="REMAT"):
        make_train_step(cfg, model, popt.Optimizer(cfg, model))
    cfg.TPU.REMAT = "none"
    cfg.SOLVER.ACCUMULATE_GRAD_BATCHES = 2
    with pytest.raises(NotImplementedError, match="ACCUMULATE"):
        popt.Optimizer(cfg, model)
