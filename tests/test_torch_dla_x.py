"""The DLA variants built from BottleneckX blocks, whose 3x3 is grouped
with cardinality 32 (DLA-X-46-C, DLA-X-60-C, DLA-X-60, DLA-X-102) or 64
(DLA-X-102-64), in the port against the JAX package, on the CPU in fp32:

- each trunk's six levels against JAX's on the same seeded weights, and the
  names both ways, as tests/test_torch_dla_bottleneck.py holds the
  Bottleneck variants;
- one whole train step of DLA-X-46-C against JAX's, with the bounds and
  the f64 oracle of tests/test_torch_train.py;
- the grouped int8 conv's route for every grouped conv of each variant:
  C/g = planes * cardinality / 32 / cardinality, so DLA-X-60's levels 2-5
  give C/g = 4, 8, 16 and 32 (O/g the same), 4 and 8 on `narrow`, 16 and 32
  on `mma`; the -C variants' 2, 2, 4 and 8 all on `narrow`;
- the plain grouped int8 conv at C/g = 2, 4, 8 and 32, stride 1 and 2,
  against JAX's `_int8_conv` with feature_group_count: accumulators bit for
  bit, the dequant bit for bit to its written arithmetic and within
  2^-23 * max(|acc * scale| + |bias|) of JAX's (tests/test_torch_int8.py's
  bound);
- static int8 on the DLA-X-60 trunk (QUANT_MIN_CH 32): every grouped conv
  quantizes through `int8_conv_grouped` (its plain version here) on the
  route its shape takes, the static forward equals the dynamic one bit for
  bit, and the scale keys and tags are those JAX's int8 trunk observes
  (traced, not run).
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dd3d_tpu_torch.ops.int8_conv as int8_ops
from dd3d_tpu.models import layers as jl
from dd3d_tpu_torch.models import layers as pl
from dd3d_tpu_torch.models.dla import DLA_VARIANTS
from dd3d_tpu_torch.ops.int8_conv import (dequant_plain, grouped_route, int8_conv_grouped_acc_plain,
                                          int8_conv_grouped_plain)
from dd3d_tpu_torch.utils.convert_checkpoint import assign_quant_paths

from tests.test_torch_dla_bottleneck import assert_names_both_ways, assert_trunk_matches_jax, trunk_pair
from tests.test_torch_train import assert_close_per_tensor, make_train_step_case, small_cfg
from tests.torch_port_util import jax_quant_globals_restored, torch_threads

X_VARIANTS = ["DLA-X-46-C", "DLA-X-60-C", "DLA-X-60", "DLA-X-102", "DLA-X-102-64"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


@pytest.mark.parametrize("name", X_VARIANTS)
def test_bottleneck_x_trunk_matches_jax(name):
    variables, pt = assert_trunk_matches_jax(name)
    assert_names_both_ways(variables, pt)
    grouped = [m for m in pt.modules() if isinstance(m, pl.ConvNorm) and m.groups > 1]
    cardinality = 64 if name.endswith("-64") else 32
    assert grouped and all(m.groups == cardinality and m.kernel_size == 3 for m in grouped)


def grouped_convs(name):
    """{(C, O, stride, groups): count} of the variant's grouped convs."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models.dla import _dla_trunk

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.FE.BACKBONE.NAME = name
    trunk, _, _ = _dla_trunk(cfg)
    return Counter((m.weight.shape[1] * m.groups, m.weight.shape[0], m.stride, m.groups)
                   for m in trunk.modules() if isinstance(m, pl.ConvNorm) and m.groups > 1)


@pytest.mark.parametrize("name", X_VARIANTS)
def test_every_grouped_conv_takes_its_route(name):
    shapes = grouped_convs(name)
    by_cg = {}
    for (c, o, stride, g), n in shapes.items():
        assert o == c and stride in (1, 2)
        by_cg.setdefault(c // g, set()).add(grouped_route(c, o, 3, 3, stride, g))
    want = {"DLA-X-46-C": {2: {"narrow"}, 4: {"narrow"}, 8: {"narrow"}},
            "DLA-X-60-C": {2: {"narrow"}, 4: {"narrow"}, 8: {"narrow"}}}.get(
        name, {4: {"narrow"}, 8: {"narrow"}, 16: {"mma"}, 32: {"mma"}})
    assert by_cg == want
    if name == "DLA-X-60":  # 2, 4, 8 and 2 blocks at levels 2-5; each level's first 3x3 has stride 2
        assert sum(shapes.values()) == 16 and sum(n for (_, _, s, _), n in shapes.items() if s == 2) == 4


@pytest.mark.parametrize("cg,stride", [(2, 1), (4, 2), (8, 1), (32, 2), (32, 1)])
def test_plain_grouped_int8_conv_matches_jax(cg, stride):
    g = 4
    c = o = cg * g
    rng = np.random.RandomState(cg + stride)
    x = rng.randn(2, 9, 11, c).astype(np.float32)
    kernel = (rng.randn(3, 3, cg, o) * 0.2).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    xs = np.float32(np.abs(x).max()) / np.float32(127.0)
    xq = np.clip(np.rint(x / xs), -127, 127).astype(np.int8)
    ws = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), np.float32(1e-12)) / np.float32(127.0)
    wq = np.clip(np.rint(kernel / ws), -127, 127).astype(np.int8)
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g, preferred_element_type=jnp.int32))
    xq_t, wq_t = torch.from_numpy(xq), torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
    acc = int8_conv_grouped_acc_plain(xq_t, wq_t, stride, 1, g)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    scale = torch.from_numpy(np.float32(xs) * ws)
    out = int8_conv_grouped_plain(xq_t, wq_t, scale, torch.from_numpy(bias), stride, 1, torch.float32, g)
    np.testing.assert_array_equal(out.numpy(), acc_j.astype(np.float32) * (np.float32(xs) * ws) + bias)
    y_j = np.asarray(jl._int8_conv(jnp.asarray(x), jnp.asarray(kernel), strides=(stride, stride),
                                   padding=[(1, 1), (1, 1)], rhs_dilation=(1, 1), groups=g,
                                   out_dtype=jnp.float32)) + bias
    ulp = 2.0 ** -23 * float((np.abs(acc_j * (np.float64(xs) * ws)) + np.abs(bias)).max())
    assert np.abs(out.numpy() - y_j).max() <= ulp
    assert torch.equal(dequant_plain(acc, scale, None, torch.bfloat16),
                       int8_conv_grouped_plain(xq_t, wq_t, scale, None, stride, 1, torch.bfloat16, g))


def test_static_int8_trunk_runs_every_grouped_conv_on_its_route():
    jt, variables, pt = trunk_pair("DLA-X-60", seed=2)
    assign_quant_paths(pt)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)).permute(0, 3, 1, 2)
    dyn = pl.QuantSpec(enabled=True, min_ch=32, capture=[])
    with torch.no_grad(), pl.quant_scope(dyn):
        dynamic = pt(x)
    scales = {}
    for path, tag, amax in dyn.capture:
        scales.setdefault(path, {})[tag] = max(float(amax), scales.get(path, {}).get(tag, 0.0))
    routes = Counter()
    real = int8_ops.int8_conv_grouped
    with torch.no_grad(), pl.quant_scope(pl.QuantSpec(enabled=True, min_ch=32, scales=scales)) as spec, \
            pytest.MonkeyPatch.context() as mp:
        def counted(xq, wq, scale, bias, stride, pad, out_dtype, groups, route=None):
            routes[(xq.shape[-1] // groups, grouped_route(xq.shape[-1], wq.shape[0], 3, 3, stride, groups))] += 1
            return real(xq, wq, scale, bias, stride, pad, out_dtype, groups, route)

        mp.setattr(int8_ops, "int8_conv_grouped", counted)
        static = pt(x)
    assert spec.misses == []
    assert routes == {(4, "narrow"): 2, (8, "narrow"): 4, (16, "mma"): 8, (32, "mma"): 2}
    for k in dynamic:
        assert torch.equal(dynamic[k], static[k]), k
    with jax_quant_globals_restored():
        jl.QUANT_INT8, jl.QUANT_MIN_CH, jl.QUANT_UNFOLDED, jl.QUANT_SCALES = True, 32, False, {}
        jl.QUANT_OBSERVED_TAGS, jl.QUANT_SCALE_MISSES = {}, []
        jax.eval_shape(lambda v, x: jt.apply(v, x, train=False), variables, jnp.zeros((1, 64, 64, 3)))
        observed = {p: set(t) for p, t in jl.QUANT_OBSERVED_TAGS.items()}
    assert observed == {p: set(t) for p, t in scales.items()}
    assert "level4/tree1/tree1/tree1/conv2/conv" in observed


@pytest.fixture(scope="module")
def train_step_case():
    cfg = small_cfg()
    cfg.FE.BACKBONE.NAME = "DLA-X-46-C"
    return make_train_step_case(cfg)


def test_bottleneck_x_train_step_matches_jax(train_step_case):
    case = train_step_case
    mp, mj = case["metrics_p"], case["metrics_j"]
    assert set(mp) == set(mj) and mp["loss_finite"] == 1.0
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=k)
    pm, before = case["pm"], case["before"]
    assert pm.backbone.bottom_up.level2.tree1.conv2.groups == 32
    assert_close_per_tensor({n: p.grad.numpy() for n, p in pm.named_parameters()},
                            {n: g.numpy() for n, g in case["grads_j"].items()}, case["grads64"])
    names = [n for n, _ in pm.named_parameters()]
    assert_close_per_tensor({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
                            {n: (case["params_j"][n] - before[n]).numpy() for n in names}, case["updates64"])
