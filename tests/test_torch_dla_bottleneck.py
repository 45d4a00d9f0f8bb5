"""The DLA variants built from Bottleneck blocks (DLA-46-C, DLA-60, and
with residual roots DLA-102, DLA-169) in the port against the JAX package,
on the CPU in fp32 (tests/test_torch_dla_x.py holds the BottleneckX
variants):

- each trunk's six levels on the same seeded weights (LeCun-scaled kernels
  through `convert_flax_variables`, every JAX leaf placed) and a 64x64
  batch of 2 within atol = rtol = 1e-4 of the level's largest magnitude,
  as tests/test_torch_model.py; the trunk's parameter names map to JAX's
  flax paths (`conv3`, the residual root's `conv`), and a state dict in
  the port's (the reference's) names converts through the JAX package's
  reference converter into the same variables;
- one whole train step of DLA-46-C (FPN 64, 1-conv towers, 128x128, batch
  2, TPU.PALLAS_STEM_DW) against JAX's `make_train_step`, with the bounds
  and the f64 oracle of tests/test_torch_train.py: losses within 2e-4,
  every gradient and update per tensor within 5e-3 of the port's own f64
  step (1e-2 at P6, P7), JAX and the port within 1e-3 of each other in
  flat L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg as jax_experiment
from dd3d_tpu.models.dla import _dla_trunk as jax_dla_trunk
from dd3d_tpu.training.optim import _wd_mask
from dd3d_tpu.utils.convert_checkpoint import convert_torch_state_dict
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models.dla import DLA_VARIANTS, _dla_trunk
from dd3d_tpu_torch.training import optim as popt
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables, flax_param_paths

from tests.test_torch_regnet_bifpn import seeded_variables
from tests.test_torch_train import assert_close_per_tensor, make_train_step_case, small_cfg
from tests.torch_port_util import torch_threads

LEVELS = [f"level{i}" for i in range(6)]
BOTTLENECK_VARIANTS = ["DLA-46-C", "DLA-60", "DLA-102", "DLA-169"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def trunk_cfg(name, get=get_experiment_cfg):
    cfg = get("dd3d_kitti_dla34")
    cfg.FE.BACKBONE.NAME = name
    cfg.FE.BACKBONE.OUT_FEATURES = LEVELS
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def trunk_pair(name, seed=1, hw=64):
    """(JAX trunk, its seeded variables, the port's trunk in eval mode with
    the same weights) of DLA variant `name`."""
    jt, _, _ = jax_dla_trunk(trunk_cfg(name, jax_experiment), jnp.float32)
    shapes = jax.eval_shape(lambda r, x: jt.init(r, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 3)))
    variables = seeded_variables(shapes, seed)
    pt, _, _ = _dla_trunk(trunk_cfg(name))
    pt.load_state_dict(convert_flax_variables(variables, pt), strict=True)
    return jt, variables, pt.eval()


def assert_trunk_matches_jax(name, seed=1):
    jt, variables, pt = trunk_pair(name, seed)
    x = np.random.RandomState(seed).randn(2, 64, 64, 3).astype(np.float32)
    out_j = jax.jit(lambda v, x: jt.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        out_p = pt(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert list(out_p) == LEVELS == sorted(out_j)
    channels = DLA_VARIANTS[name][1]
    for i, k in enumerate(LEVELS):
        want = np.asarray(out_j[k])
        assert out_p[k].shape == (2, channels[i], 64 >> i, 64 >> i), k
        top = float(np.abs(want).max())
        assert top > 0.1, k
        np.testing.assert_allclose(out_p[k].permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4 * top,
                                   err_msg=f"{name} {k}")
    return variables, pt


def assert_names_both_ways(variables, pt):
    """The port's parameter names -> JAX's flax paths, as the weight-decay
    mask reads them; and the port's state dict, in the reference's names,
    through the JAX package's converter gives back the same variables."""
    paths = flax_param_paths(pt)
    flat = {"/".join(str(p.key) for p in k): bool(v)
            for k, v in jax.tree_util.tree_leaves_with_path(_wd_mask(variables["params"], True))}
    assert {"/".join(p) for p in paths.values()} == set(flat)
    assert all(popt.weight_decay_mask(pt, True).values())  # no per-level norm in a trunk
    sd = {k: v.numpy() for k, v in pt.state_dict().items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats = convert_torch_state_dict(sd, zeros, strict=True)
    for coll, tree in (("params", params), ("batch_stats", stats)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            want = variables[coll]
            for k in path:
                want = want[k.key]
            np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=f"{coll} {path}")


@pytest.mark.parametrize("name", BOTTLENECK_VARIANTS)
def test_bottleneck_trunk_matches_jax(name):
    variables, pt = assert_trunk_matches_jax(name)
    assert_names_both_ways(variables, pt)
    block = pt.level5.tree1 if DLA_VARIANTS[name][0][5] == 1 else pt.level5.tree1.tree1
    assert type(block).__name__ == "Bottleneck" and block.conv2.weight.shape[0] == block.conv3.weight.shape[1]
    residual_root = DLA_VARIANTS[name][3]
    assert all(m.residual == residual_root for n, m in pt.named_modules() if n.endswith(".root"))


@pytest.fixture(scope="module")
def train_step_case():
    cfg = small_cfg()
    cfg.FE.BACKBONE.NAME = "DLA-46-C"
    return make_train_step_case(cfg)


def test_bottleneck_train_step_matches_jax(train_step_case):
    case = train_step_case
    mp, mj = case["metrics_p"], case["metrics_j"]
    assert set(mp) == set(mj) and mp["loss_finite"] == 1.0
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=k)
    pm, before = case["pm"], case["before"]
    assert pm.backbone.bottom_up.level5.tree1.conv3.weight.grad is not None
    assert_close_per_tensor({n: p.grad.numpy() for n, p in pm.named_parameters()},
                            {n: g.numpy() for n, g in case["grads_j"].items()}, case["grads64"])
    names = [n for n, _ in pm.named_parameters()]
    assert_close_per_tensor({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
                            {n: (case["params_j"][n] - before[n]).numpy() for n in names}, case["updates64"])
