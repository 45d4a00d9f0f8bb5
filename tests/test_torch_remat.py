"""TPU.REMAT in the port's train step (dd3d_tpu_torch/training/remat.py), on
the CPU, at tests/test_torch_train.py's small model (DLA-34 trunk, FPN 64,
1-conv towers, 128x128, the stem's weight gradient routed):

- every mapped policy gives the "none" step's losses, gradients, updated
  parameters and BN running stats bit for bit, and the recompute ran as
  the policy says (the forward's convolutions again under "full", none of
  them under "dots_saveable"), with the running averages updated once;
- (tests/test_torch_remat_jax.py: "full" and "dots_saveable" against JAX's
  step of the same policy;)
- the name table covers every public name of jax.checkpoint_policies: the
  factories raise NotImplementedError (JAX fails on them too), other names
  ValueError; JAX's forward of the model holds no dot_general;
- DD3DDenseDepth's two-argument forward under "full", bit for bit;
- backward from a fresh thread recomputes under the first forward's context
  variables;
- two gloo ranks (DDP, SyncBN) under "full" equal them under "none" in f64,
  with the same SyncBN all-reduces again in the recompute.
"""
import contextvars
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu_torch.models.layers import RECOMPUTING, FoldableBatchNorm
from dd3d_tpu_torch.training import remat
from dd3d_tpu_torch.training.synthetic import synthetic_batch
from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
from dd3d_tpu_torch.training.train_step import make_train_step
from tests.test_torch_train import seeded_model, small_cfg
from tests.torch_dist_workers import remat_ddp_rank
from tests.torch_port_util import run_gloo, torch_threads

MAPPED = [name for name, policy in remat.POLICIES.items() if name not in ("none", "")]
# names of one policy: jax.checkpoint_policies holds the dots pairs as one
# function, and "full" is jax.checkpoint with no policy, which saves nothing
ALIASES = {"nothing_saveable": "full", "checkpoint_dots": "dots_saveable",
           "checkpoint_dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


class OpCounter(TorchDispatchMode):
    """aten.convolution calls, in the first forward and in a recompute."""

    def __init__(self):
        super().__init__()
        self.first = self.again = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            if RECOMPUTING.get():
                self.again += 1
            else:
                self.first += 1
        return func(*args, **(kwargs or {}))


def port_step(policy: str, dense_depth: bool = False):
    """One train step of the small model (as DD3DDenseDepth, whose forward
    also takes the inverse intrinsics, with `dense_depth`) under TPU.REMAT
    = `policy`: its metrics, gradients, parameters and BN buffers after it,
    the convolutions it ran, and the live-BN forwards with and without
    RECOMPUTING."""
    cfg = small_cfg()
    cfg.TPU.REMAT = policy
    if dense_depth:
        cfg.MODEL.META_ARCHITECTURE, cfg.MODEL.DEPTH_ON = "DD3DDenseDepth", True
    model = seeded_model(cfg)
    state = create_train_state(cfg, model, "cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    batch = to_device(synthetic_batch(np.random.RandomState(1), 2, 128, 128, max_gt=16, max_gt_per_image=6,
                                      depth_density=0.3 if dense_depth else 0.0), "cpu")
    norms = {False: 0, True: 0}
    affine = FoldableBatchNorm.affine

    def counting_affine(self, x):
        norms[RECOMPUTING.get()] += 1
        return affine(self, x)

    with pytest.MonkeyPatch.context() as mp, OpCounter() as ops:
        mp.setattr(FoldableBatchNorm, "affine", counting_affine)
        metrics = step(batch)
    return {"metrics": metrics, "grads": {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
            "params": {n: p.detach() for n, p in model.named_parameters()},
            "buffers": {n: b for n, b in model.named_buffers()}, "convs": (ops.first, ops.again), "norms": norms}


@pytest.fixture(scope="module")
def none_step():
    """The "none" step, and the convolutions of the forward alone (the step
    also runs one in backward: the stem conv's input gradient)."""
    step = port_step("none")
    cfg = small_cfg()
    model = seeded_model(cfg).train()
    images = to_device(synthetic_batch(np.random.RandomState(1), 2, 128, 128), "cpu")["image"]
    with torch.no_grad(), OpCounter() as ops:
        model(images)
    step["forward_convs"] = ops.first
    return step


@pytest.mark.parametrize("policy", MAPPED)
def test_policy_step_equals_none_bit_for_bit(none_step, policy):
    if policy in ALIASES:  # the same policy as its alias's, whose step is held below
        alias = ALIASES[policy]
        assert remat.POLICIES[policy] is remat.POLICIES[alias]
        if policy.startswith("checkpoint_"):
            assert getattr(jax.checkpoint_policies, policy) is getattr(jax.checkpoint_policies, alias)
        return
    got = port_step(policy)
    for kind in ("metrics", "grads", "params", "buffers"):
        assert list(got[kind]) == list(none_step[kind]), kind
        for name, want in none_step[kind].items():
            assert torch.equal(got[kind][name], want), f"{policy}: {kind} {name}"
    first, again = got["convs"]
    assert first == none_step["convs"][0] > none_step["forward_convs"] > 50 and none_step["convs"][1] == 0
    saves = remat.POLICIES[policy]
    if saves is None:  # everything_saveable: no checkpoint
        assert again == 0 and got["norms"][True] == 0
    elif saves != remat.FULL and torch.ops.aten.convolution.default in saves:  # dots_saveable: every conv output kept
        assert again == 0 and got["norms"][True] == got["norms"][False] > 0
    else:  # full, nothing_saveable, and dots_with_no_batch_dims_saveable (no 2-D matmul in the model)
        assert again == none_step["forward_convs"] and got["norms"][True] == got["norms"][False] > 0


def test_dense_depth_step_equals_none_bit_for_bit():
    """DD3DDenseDepth's two-argument forward under the checkpoint: the
    "none" step bit for bit, the recompute run."""
    want, got = port_step("none", dense_depth=True), port_step("full", dense_depth=True)
    for kind in ("metrics", "grads", "params", "buffers"):
        assert list(got[kind]) == list(want[kind]), kind
        for name, w in want[kind].items():
            assert torch.equal(got[kind][name], w), f"{kind} {name}"
    assert any(k.startswith("loss_dense_depth") for k in want["metrics"])
    assert got["convs"][1] > 50 and want["convs"][1] == 0


def test_policy_names_cover_jax():
    public = {n for n in dir(jax.checkpoint_policies) if not n.startswith("_")}
    assert public <= set(remat.POLICIES) | set(remat.FACTORIES)
    assert set(remat.FACTORIES) <= public
    cfg = small_cfg()
    model = seeded_model(cfg)
    state = create_train_state(cfg, model, "cpu")
    for name in remat.FACTORIES:
        cfg.TPU.REMAT = name
        with pytest.raises(NotImplementedError, match=name):
            make_train_step(cfg, state.model, state.optimizer)
        # JAX's step fails on it too: the factory is not a policy
        f = jax.checkpoint(lambda x: jnp.sin(x @ x.T), policy=getattr(jax.checkpoint_policies, name))
        with pytest.raises(TypeError):
            jax.grad(lambda x: f(x).sum())(jnp.ones((3, 3)))
    cfg.TPU.REMAT = "dots_everything"
    with pytest.raises(ValueError, match="Unknown TPU.REMAT policy 'dots_everything'"):
        make_train_step(cfg, state.model, state.optimizer)


def test_jax_forward_has_no_dot_general():
    """Why dots_with_no_batch_dims_saveable recomputes everything: JAX's
    train-mode forward of the model holds convolutions and no dot_general."""
    cfg = small_cfg()
    jm = build_jax_model(cfg)
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    variables = jax.tree_util.tree_map(lambda s: jnp.ones(s.shape, s.dtype), shapes)
    jaxpr = jax.make_jaxpr(lambda v: jm.apply(v, x, train=True, mutable=["batch_stats"]))(variables)

    def prims(jp):
        for eqn in jp.eqns:
            yield eqn.primitive.name
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else [p]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        yield from prims(inner)

    names = list(prims(jaxpr.jaxpr))
    assert names.count("conv_general_dilated") > 50 and "dot_general" not in names


SEEN = contextvars.ContextVar("seen", default="unset")


class ReadsContext(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.full((4,), 0.5))
        self.log = []

    def forward(self, x):
        self.log.append((SEEN.get(), RECOMPUTING.get(), threading.get_ident()))
        return torch.sin(x * self.weight) * 2


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_recompute_in_another_thread_sees_the_first_forward_context(policy):
    module = ReadsContext()
    token = SEEN.set("first forward's")
    try:
        with remat.checkpointed_forward(module, remat.remat_policy(policy)):
            y = module(torch.linspace(0, 1, 4))
    finally:
        SEEN.reset(token)
    assert "forward" not in module.__dict__  # restored after the call
    errors = []

    def backward():
        try:
            y.sum().backward()
        except Exception as e:  # re-raised in the test's thread
            errors.append(e)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert not errors, errors
    (first, first_rec, first_thread), (again, again_rec, again_thread) = module.log
    assert first == again == "first forward's" and not first_rec and again_rec
    assert again_thread != first_thread and SEEN.get() == "unset"
    want = 2 * torch.cos(torch.linspace(0, 1, 4) * 0.5) * torch.linspace(0, 1, 4)
    torch.testing.assert_close(module.weight.grad, want, rtol=0, atol=1e-6)


def test_two_rank_full_equals_none_f64(tmp_path):
    rng = np.random.RandomState(3)
    batches = [synthetic_batch(rng, 4, 64, 128, max_gt=8, max_gt_per_image=4)]
    ranks = run_gloo(remat_ddp_rank, 2, batches, ("none", "full"), out_dir=tmp_path, timeout_s=300)
    for rank in ranks:
        none, full = rank["none"], rank["full"]
        assert full["losses"] == none["losses"]
        for kind in ("grads", "params", "buffers"):
            assert list(full[kind]) == list(none[kind])
            for name, want in none[kind].items():
                assert torch.equal(full[kind][name], want), f"{kind} {name}"
        # the recompute's SyncBN all-reduces: as many again as the forward's
        assert full["syncbn_allreduces"] == 2 * none["syncbn_allreduces"] > 0
    for name, p in ranks[0]["full"]["params"].items():
        assert torch.equal(p, ranks[1]["full"]["params"][name]), name
