"""The int8 quantize fused into the int8 conv's epilogue along the head
towers (models/layers.run_tower, `TowerConv.link_amax`,
ops/int8_conv.int8_conv(..., requant=)), and the standalone quantize's
division-free arithmetic (csrc/quantize.cuh), on the CPU:

- small FCOS2D + FCOS3D heads (16 channels, all 4 tower convs, 5 levels,
  static scales calibrated on the same features): the fused path's outputs
  equal the unfused path's bit for bit, through the kernels' plain
  versions, in fp32 and bf16, with 60 links fused;
- the same heads against JAX's int8 heads (eager flax apply, static
  scales), within one ulp of each output's largest magnitude: the bound of
  tests/test_torch_int8.py::test_tower_conv_quant_branch, 2^-23 x the
  magnitude before the last rounding, doubled for the Scale and Offset
  that follow the predictor conv;
- every rule that keeps a link unfused, each with the unfused outputs;
- a numpy model of `quantize_one` (a product, and an exact residual next
  to a .5 tie) against the IEEE division on all 65,536 bf16 patterns but
  NaN at the path's scales, powers of two and random ones, and on f32
  values at and next to every .5 tie;
- the quantized-activation holder raises on a scale it was not made at.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dd3d_tpu_torch.ops.int8_conv as int8_ops
from dd3d_tpu.models import layers as jl
from dd3d_tpu.models.fcos2d import FCOS2DHead as JaxFCOS2DHead
from dd3d_tpu.models.fcos3d import FCOS3DHead as JaxFCOS3DHead
from dd3d_tpu_torch.models import layers as pl
from dd3d_tpu_torch.models.fcos2d import FCOS2DHead
from dd3d_tpu_torch.models.fcos3d import FCOS3DHead
from dd3d_tpu_torch.ops.int8_conv import (QuantizedActivation, int8_conv, int8_conv_dequant, int8_conv_requant_plain,
                                          static_scale)
from dd3d_tpu_torch.ops.quantize import quantize_int8_plain
from dd3d_tpu_torch.utils.convert_checkpoint import assign_quant_paths, convert_flax_variables

from tests.torch_port_util import jax_quant_globals_restored, torch_threads

WIDTH, CLASSES = 16, 3
STRIDES = (8, 16, 32, 64, 128)
LEVEL_HW = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))
MEAN_DEPTH, STD_DEPTH = (32.6, 15.2, 8.4, 5.0, 4.7), (14.3, 7.9, 4.3, 2.3, 2.0)
LINKS = 3 * 4 * len(STRIDES)  # three towers of four convs, each conv's output read by one int8 conv


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads():
        yield


class JaxHeads(jl.nn.Module):
    """The JAX package's two heads under the DD3D model's scope names."""

    @jl.nn.compact
    def __call__(self, features):
        out2d = JaxFCOS2DHead(CLASSES, STRIDES, norm="FrozenBN", dtype=jnp.float32, name="fcos2d_head")(features)
        out3d = JaxFCOS3DHead(CLASSES, STRIDES, MEAN_DEPTH, STD_DEPTH, dtype=jnp.float32, name="fcos3d_head")(features)
        return out2d, out3d


class Heads(torch.nn.Module):
    """The port's two heads under the same names; `forward` returns
    {output name: per-level NCHW tensors}."""

    def __init__(self):
        super().__init__()
        self.fcos2d_head = FCOS2DHead(CLASSES, WIDTH, STRIDES, norm="FrozenBN")
        self.fcos3d_head = FCOS3DHead(CLASSES, WIDTH, STRIDES, MEAN_DEPTH, STD_DEPTH)

    def forward(self, features, return_cls_tower=False):
        out2d = self.fcos2d_head(features, return_cls_tower=return_cls_tower)
        names = ("logits", "box2d_reg", "centerness", "cls_tower")[:len(out2d)]
        out = dict(zip(names, out2d))
        out.update(zip(("quat", "ctr", "depth", "size", "conf"), self.fcos3d_head(features)))
        return out


def _randomize(tree, rng):
    def leaf(path, x):
        if path[-1].key == "var":
            return (rng.rand(*x.shape) * 0.5 + 0.5).astype(np.float32)
        return (rng.randn(*x.shape) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def heads():
    """(features NHWC numpy, JAX module, its variables, the port's heads in
    eval mode with the same weights, static scales calibrated on the
    features)."""
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, h, w, WIDTH).astype(np.float32) for h, w in LEVEL_HW]
    jm = JaxHeads()
    variables = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]), rng)
    pm = Heads().eval()
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    assign_quant_paths(pm)
    spec = pl.QuantSpec(enabled=True, min_ch=0, unfolded=True, capture=[])
    with torch.no_grad(), pl.quant_scope(spec):
        pm(_port_features(feats, torch.float32))
    scales = {}
    for path, tag, amax in spec.capture:
        scales.setdefault(path, {})[tag] = max(float(amax), scales.get(path, {}).get(tag, 0.0))
    return feats, jm, variables, pm, scales


def _port_features(feats, dtype):
    return [torch.from_numpy(f).permute(0, 3, 1, 2).to(dtype) for f in feats]  # channels_last NCHW views


@contextlib.contextmanager
def _fusion_off():
    """The unfused path: no link finds a consumer's amax."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl.TowerConv, "link_amax", lambda *args: None)
        yield


@contextlib.contextmanager
def _counted_links():
    """Count the int8 convs that run with the s8 epilogue."""
    links, real = [], int8_ops.int8_conv

    def count(*args, **kwargs):
        if kwargs.get("requant") is not None:
            links.append(args[0].shape)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_ops, "int8_conv", count)
        yield links


def _run(pm, feats, dtype, **kw):
    spec_kw = {k: kw.pop(k) for k in ("min_ch", "unfolded", "scales", "capture") if k in kw}
    spec = pl.QuantSpec(enabled=True, **{"min_ch": 0, "unfolded": True, **spec_kw})
    with torch.no_grad(), pl.quant_scope(spec):
        return pm(_port_features(feats, dtype), **kw), spec


def _assert_identical(a, b):
    assert list(a) == list(b)
    for key in a:
        for lvl, (x, y) in enumerate(zip(a[key], b[key])):
            assert isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor), f"{key}[{lvl}]"
            assert x.dtype == y.dtype and torch.equal(x, y), f"{key}[{lvl}]"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_heads_equal_the_unfused_path(heads, dtype):
    feats, _, _, pm, scales = heads
    with _counted_links() as links:
        fused, spec = _run(pm, feats, dtype, scales=scales)
    with _fusion_off(), _counted_links() as none:
        unfused, spec_u = _run(pm, feats, dtype, scales=scales)
    assert len(links) == LINKS and none == []
    assert spec.misses == spec_u.misses == []
    _assert_identical(fused, unfused)


def test_fused_heads_match_jax_int8_heads(heads):
    feats, jm, variables, pm, scales = heads
    with jax_quant_globals_restored():
        jl.QUANT_INT8, jl.QUANT_MIN_CH, jl.QUANT_UNFOLDED, jl.QUANT_SCALES = True, 0, True, scales
        jl.QUANT_OBSERVED_TAGS, jl.QUANT_SCALE_MISSES = {}, []
        out2d, out3d = jm.apply(variables, [jnp.asarray(f) for f in feats])
        assert jl.QUANT_SCALE_MISSES == []
    jax_out = dict(zip(("logits", "box2d_reg", "centerness", "quat", "ctr", "depth", "size", "conf"),
                       list(out2d[:3]) + list(out3d)))
    with _counted_links() as links:
        port, _ = _run(pm, feats, torch.float32, scales=scales)
    assert len(links) == LINKS
    for key, levels in jax_out.items():
        for lvl, (j, p) in enumerate(zip(levels, port[key])):
            j = np.asarray(j)
            ulp = 2.0 ** -22 * float(np.abs(j).max())
            np.testing.assert_allclose(p.permute(0, 2, 3, 1).numpy(), j, rtol=0, atol=ulp,
                                       err_msg=f"{key} level {lvl}")


MISSING = ("fcos2d_head/cls_tower_conv2", f"{LEVEL_HW[1][0]}x{LEVEL_HW[1][1]}x{WIDTH}")


@pytest.mark.parametrize("rule", ["capture", "missing_scale", "min_ch", "folded_only", "return_cls_tower"])
def test_links_that_stay_unfused(heads, caplog, rule):
    """Each rule keeps its links on the unfused path, and the outputs stay
    the unfused path's: capture on (calibration needs the bf16 maxima); a
    consumer without a scale at the producer's output tag (the miss is
    recorded and warned once, by the consumer); QUANT_MIN_CH above the
    width (no tower conv quantizes); QUANT_UNFOLDED off (the predictors
    stay fp: each tower's last link); return_cls_tower (the cls tower's
    output has a second reader)."""
    feats, _, _, pm, scales = heads
    kw, fused = {"scales": scales}, LINKS
    if rule == "capture":
        kw["capture"], fused = [], 0
    elif rule == "missing_scale":
        kw["scales"] = {p: {t: a for t, a in v.items() if (p, t) != MISSING} for p, v in scales.items()}
        fused = LINKS - 1
    elif rule == "min_ch":
        kw["min_ch"], fused = WIDTH + 1, 0
    elif rule == "folded_only":
        kw["unfolded"], fused = False, LINKS - 3 * len(STRIDES)
    else:
        kw["return_cls_tower"], fused = True, LINKS - len(STRIDES)
    caplog.clear()
    with _counted_links() as links:
        got, spec = _run(pm, feats, torch.bfloat16, **dict(kw, capture=[] if rule == "capture" else None))
    with _fusion_off():
        want, spec_u = _run(pm, feats, torch.bfloat16, **dict(kw, capture=[] if rule == "capture" else None))
    assert len(links) == fused
    _assert_identical(got, want)
    assert spec.misses == spec_u.misses == ([MISSING] if rule == "missing_scale" else [])
    if rule == "missing_scale":
        warned = [r for r in caplog.records if "no calibrated scale" in r.getMessage()]
        assert len(warned) == 2  # once in each of the two forwards: never twice in one
    if rule == "capture":
        assert [(p, t) for p, t, _ in spec.capture] == [(p, t) for p, t, _ in spec_u.capture]


# ---- the standalone quantize's arithmetic ------------------------------------

MARGIN = np.float32(2.0 ** -15)


def quantize_model(x: np.ndarray, xs: np.float32) -> np.ndarray:
    """csrc/quantize.cuh::quantize_one in numpy float32 (IEEE, round to
    nearest even): the product t by fl(1 / xs) and its rint; within MARGIN
    of a .5 tie b (|t - rint(t)| >= 0.5 - MARGIN), the exact residual
    x - b * xs (the FMA's, computed in float64, where it is exact) against
    half an ulp of b; the division where xs is out of [2^-100, 2^100]; the
    clip."""
    x = x.astype(np.float32)
    xs = np.float32(xs)
    if not 2.0 ** -100 <= xs <= 2.0 ** 100:
        return divided(x, xs)
    with np.errstate(all="ignore"):
        r = np.float32(1.0) / xs
        t = x * r
        k = np.floor(t)
        b = k + np.float32(0.5)
        s = (x.astype(np.float64) - b.astype(np.float64) * np.float64(xs)).astype(np.float32)
        h = np.ldexp(np.float32(1.0), np.frexp(b)[1] - 25).astype(np.float32) * xs
        tie = np.where(np.abs(s) <= h, np.rint(b), np.where(s > 0, k + np.float32(1.0), k))
        n = np.rint(t)
        q = np.where(np.abs(t - n) >= np.float32(0.5) - MARGIN, tie, n)
        return np.clip(q, -127, 127).astype(np.int8)


def divided(x: np.ndarray, xs: np.float32) -> np.ndarray:
    with np.errstate(all="ignore"):
        return np.clip(np.rint(x.astype(np.float32) / np.float32(xs)), -127, 127).astype(np.int8)


def all_bf16() -> np.ndarray:
    """The 65,536 bf16 bit patterns but the NaNs, as float32."""
    x = (np.arange(2 ** 16, dtype=np.uint32) << 16).view(np.float32)
    return x[~np.isnan(x)]


def test_quantize_model_equals_the_division_on_every_bf16_value(heads):
    """The path's calibrated scales (the heads' static amaxes), powers of
    two and random f32 scales: ~20, each over all non-NaN bf16 values."""
    *_, scales = heads
    calibrated = sorted({static_scale(a) for v in scales.values() for a in v.values()})
    rng = np.random.RandomState(5)
    xs_all = ([np.float32(s) for s in calibrated[::max(1, len(calibrated) // 8)][:8]]
              + [np.float32(2.0 ** e) for e in (-20, -7, -1, 0, 3, 10)]
              + [np.float32(v) for v in np.exp(rng.uniform(-12, 6, 6))])
    assert len(xs_all) >= 18
    x = all_bf16()
    assert x.size == 65536 - 254
    slow = 0
    for xs in xs_all:
        np.testing.assert_array_equal(quantize_model(x, xs), divided(x, xs), err_msg=f"xs={xs!r}")
        with np.errstate(all="ignore"):
            t = x * (np.float32(1) / xs)
            slow += int(((np.abs(t) < 128) & (np.abs((t - np.floor(t)) - np.float32(0.5)) <= MARGIN)).sum())
    assert slow > 0  # some values fall within the margin: the tie step is exercised
    # the plain version the kernel is held to on the card gives the division's codes too
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(quantize_int8_plain(xt, torch.tensor([xs_all[0]])).numpy(),
                                  divided(x, xs_all[0]))


def test_quantize_model_equals_the_division_next_to_ties():
    """f32 values at and 8 ulps either side of every (k + 0.5) * xs, the
    clip's edge, zeros and infinities, at scales where the product by 1/xs
    and the quotient round apart (the Pallas kernel's 0.0312 among them);
    and scales whose reciprocal is not a normal float, which take the
    division everywhere."""
    k = np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)
    specials = np.float32([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30])
    apart = 0
    for xs in (np.float32(0.0312), np.float32(0.125), np.float32(1.0) / np.float32(3.0), np.float32(7.3e-3)):
        base = (k * xs).astype(np.float32)
        x = np.concatenate([(base.view(np.int32) + d).view(np.float32) for d in range(-8, 9)] + [specials])
        np.testing.assert_array_equal(quantize_model(x, xs), divided(x, xs), err_msg=f"xs={xs!r}")
        with np.errstate(all="ignore"):
            apart += int((np.clip(np.rint(x * (np.float32(1) / xs)), -127, 127) != divided(x, xs)).sum())
    assert apart > 0  # the product alone would give other codes here
    x = all_bf16()
    for xs in (np.float32(0.0), np.float32(2.0 ** 127), np.float32(np.inf)):
        np.testing.assert_array_equal(quantize_model(x, xs), divided(x, xs), err_msg=f"xs={xs!r}")


# ---- the wrappers ------------------------------------------------------------

def test_requant_on_the_cpu_is_the_composition():
    rng = np.random.RandomState(3)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 5, 7, 16)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (24, 3, 3, 16)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(24).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.randn(24).astype(np.float32))
    xs_next = torch.tensor([0.01], dtype=torch.float32)
    before = (int8_conv.launches, dict(int8_conv.launches_by_out))
    for dt in (torch.bfloat16, torch.float32):
        got = int8_conv(xq, wq, scale, bias, 1, 1, dt, requant=xs_next)
        want = quantize_int8_plain(torch.relu(int8_ops.int8_conv_plain(xq, wq, scale, bias, 1, 1, dt)), xs_next)
        assert got.dtype == torch.int8 and got.shape == (2, 5, 7, 24)
        assert torch.equal(got, want) and torch.equal(got, int8_conv_requant_plain(xq, wq, scale, bias, 1, 1, dt,
                                                                                   xs_next))
        assert (got == 0).any() and (got > 0).any()  # the ReLU zeroed some, others passed
    assert (int8_conv.launches, int8_conv.launches_by_out) == before  # no kernel ran
    with pytest.raises(ValueError, match="one-element float32"):
        int8_conv(xq, wq, scale, bias, 1, 1, torch.float32, requant=torch.tensor([0.1, 0.2]))


def test_quantized_activation_raises_on_another_scale():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 16, 6, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 16, 3, 3).astype(np.float32))
    held = int8_conv_dequant(x, w, None, 1, 1, torch.float32, 3.0, requant_amax=2.0)
    assert isinstance(held, QuantizedActivation) and held.codes.dtype == torch.int8
    assert held.shape == (1, 8, 6, 8) and held.xs_value == static_scale(2.0)
    w2 = torch.from_numpy(rng.randn(4, 8, 3, 3).astype(np.float32))
    y = int8_conv_dequant(held, w2, None, 1, 1, torch.float32, 2.0)  # the amax it was made at: accepted
    relu = torch.relu(int8_conv_dequant(x, w, None, 1, 1, torch.float32, 3.0))
    assert torch.equal(y, int8_conv_dequant(relu, w2, None, 1, 1, torch.float32, 2.0))
    for amax in (2.5, None):
        with pytest.raises(ValueError, match="made at scale"):
            int8_conv_dequant(held, w2, None, 1, 1, torch.float32, amax)
