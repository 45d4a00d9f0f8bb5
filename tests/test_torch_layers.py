"""The port's layers (dd3d_tpu_torch/models/layers.py) against the flax
modules of dd3d_tpu/models/layers.py, fp32, on the same random weights.

Tolerance 1e-5 (absolute and relative): both sides are fp32 convolutions of
at most 3*3*16 = 144 products per output, summed in other orders by XLA and
by PyTorch's CPU convolution; the folded affine is the same fp32 arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.models import layers as jl
from dd3d_tpu_torch.models import layers as pl
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables

from tests.torch_port_util import to_torch_nchw

TOL = dict(atol=1e-5, rtol=1e-5)


def _randomize(tree, rng):
    """Random values of the tree's shapes; variances kept positive."""
    def leaf(path, x):
        if path[-1].key == "var":
            return (rng.rand(*x.shape) * 0.5 + 0.5).astype(np.float32)
        return (rng.randn(*x.shape) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def _init(module, x, *args, **kw):
    return module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args, **kw)


@pytest.mark.parametrize("norm,stride,relu", [("FrozenBN", 1, True), ("BN", 2, False), ("", 1, False)])
def test_conv_norm_folded(norm, stride, relu):
    """ConvNorm with FrozenBN (1/sqrt) and live BN (rsqrt, running stats)
    folded into the kernel in fp32, and the norm-free conv with bias."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 10, 8).astype(np.float32)
    act = jax.nn.relu if relu else None
    jm = jl.ConvNorm(16, 3, stride, norm=norm, activation=act, dtype=jnp.float32)
    variables = _randomize(_init(jm, x), rng)
    y_j = np.asarray(jm.apply(variables, jnp.asarray(x)))

    pm = pl.ConvNorm(8, 16, 3, stride, norm=norm, relu=relu).eval()
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    with torch.no_grad():
        y_p = pm(to_torch_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y_p, y_j, **TOL)


@pytest.mark.parametrize("norm", ["FrozenBN", "BN"])
def test_norm_apply_and_fold(norm):
    """The norms' own forward (the affine in the activation dtype) and their
    folded (mul, add)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    jm = jl.make_norm(norm, 8, dtype=jnp.float32)
    variables = _randomize(_init(jm, x), rng)
    kw = {"use_running_average": True} if norm == "BN" else {}
    y_j = np.asarray(jm.apply(variables, jnp.asarray(x), **kw))
    mul_j, add_j = jm.apply(variables, method=lambda m: m.folded())

    pm = pl.make_norm(norm, 8).eval()
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    with torch.no_grad():
        y_p = pm(to_torch_nchw(x)).permute(0, 2, 3, 1).numpy()
        mul_p, add_p = pm.folded()
    np.testing.assert_allclose(y_p, y_j, **TOL)
    np.testing.assert_allclose(mul_p.numpy(), np.asarray(mul_j), **TOL)
    np.testing.assert_allclose(add_p.numpy(), np.asarray(add_j), **TOL)


def test_fused_predictor_apply():
    """Sibling predictors as one conv, including a bias-free one (the depth
    predictor), against flax's fused_predictor_apply and each standalone conv."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 7, 16).astype(np.float32)
    specs = [(4, True), (1, False), (3, True)]

    class Siblings(jl.nn.Module):
        @jl.nn.compact
        def __call__(self, x):
            preds = [jl.PredictorConv(f, 16, use_bias=b, dtype=jnp.float32, name=f"p{i}")
                     for i, (f, b) in enumerate(specs)]
            return jl.fused_predictor_apply(x, preds, jnp.float32)

    jm = Siblings()
    variables = _randomize(_init(jm, x), rng)
    outs_j = jm.apply(variables, jnp.asarray(x))

    preds = [pl.PredictorConv(16, f, bias=b) for f, b in specs]
    for i, p in enumerate(preds):
        p.load_state_dict(convert_flax_variables({"params": variables["params"][f"p{i}"]}, p), strict=True)
    xt = to_torch_nchw(x)
    with torch.no_grad():
        outs_p = pl.fused_predictor_apply(xt, preds)
        alone = [p(xt) for p in preds]
    for oj, op, oa in zip(outs_j, outs_p, alone):
        np.testing.assert_allclose(op.permute(0, 2, 3, 1).numpy(), np.asarray(oj), **TOL)
        np.testing.assert_allclose(op.numpy(), oa.numpy(), **TOL)


@pytest.mark.parametrize("norm", ["BN", "FrozenBN"])
def test_per_level_norms_and_tower_conv(norm):
    """PerLevelNorms by explicit level, and the head-tower layer that folds
    each level's norm into its own application of the shared kernel."""
    rng = np.random.RandomState(3)
    levels, c = 3, 8
    xs = [rng.randn(2, 8 >> l, 10 >> l, c).astype(np.float32) for l in range(levels)]

    class Tower(jl.nn.Module):
        @jl.nn.compact
        def __call__(self, xs):
            conv = jl.FoldableConv(c, kernel_size=3, dtype=jnp.float32, name="conv")
            norms = jl.PerLevelNorms(levels, c, norm, dtype=jnp.float32, name="norms")
            out = []
            for l, x in enumerate(xs):
                fold = norms(None, l, False, fold_query=True)
                out.append((jax.nn.relu(conv(x, *fold)), norms(x, l, False)))
            return out

    jm = Tower()
    variables = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]), rng)
    outs_j = jm.apply(variables, [jnp.asarray(x) for x in xs])

    tower = pl.TowerConv(c, levels, norm).eval()
    with torch.no_grad():
        tower.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        for l in range(levels):
            nm = tower.norm[l]
            owner = variables["params"] if norm == "BN" else variables["batch_stats"]
            nm.weight.copy_(torch.from_numpy(np.asarray(owner["norms"][f"norm{l}"]["scale"])))
            nm.bias.copy_(torch.from_numpy(np.asarray(owner["norms"][f"norm{l}"]["bias"])))
            nm.running_mean.copy_(torch.from_numpy(np.asarray(variables["batch_stats"]["norms"][f"norm{l}"]["mean"])))
            nm.running_var.copy_(torch.from_numpy(np.asarray(variables["batch_stats"]["norms"][f"norm{l}"]["var"])))
        for l, (x, (tower_j, norm_j)) in enumerate(zip(xs, outs_j)):
            xt = to_torch_nchw(x)
            np.testing.assert_allclose(tower(xt, l).permute(0, 2, 3, 1).numpy(), np.asarray(tower_j), **TOL)
            np.testing.assert_allclose(tower.norm(xt, l).permute(0, 2, 3, 1).numpy(), np.asarray(norm_j), **TOL)


def test_scale_offset_in_activation_dtype():
    """Scale/Offset cast their fp32 parameter to the activation dtype, as flax."""
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(1, 2, 3, 4)
    s_j = jl.Scale(0.37).apply({"params": {"scale": jnp.asarray([0.37])}}, jnp.asarray(x, jnp.bfloat16))
    o_j = jl.Offset(1.3).apply({"params": {"bias": jnp.asarray([1.3])}}, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        s_p, o_p = pl.Scale(0.37)(xt), pl.Offset(1.3)(xt)
    assert s_p.dtype == o_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(s_p.float().numpy(), np.asarray(s_j, np.float32))
    np.testing.assert_array_equal(o_p.float().numpy(), np.asarray(o_j, np.float32))


def test_live_bn_refuses_train_mode():
    bn = pl.FoldableBatchNorm(4).train()
    with pytest.raises(NotImplementedError):
        bn.folded()
