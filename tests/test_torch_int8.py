"""The port's int8 serving pieces against the JAX package's, on the CPU:

- the quantize step (ops/quantize.py) and the int8 conv
  (ops/int8_conv.int8_conv_dequant) against dd3d_tpu.models.layers._int8_conv,
  bit for bit in fp32 and within one bf16 ulp in bf16 (the kernels' plain
  versions run here; chip_smoke.py and tests/test_torch_cuda.py hold the CUDA
  kernels against them on the card);
- the quant branches of ConvNorm, TowerConv and the fused predictors, with
  the QUANT_MIN_CH gate and QUANT_UNFOLDED off and on, against the flax
  modules: where both quantize, the port's int8 conv bit for bit against the
  written two-rounding dequant in numpy and within one ulp of JAX (XLA:CPU
  may contract the dequant into an FMA), 1e-5 where both run the fp32 conv
  (summation order), and P6/P7 never quantized;
- the quant state: scale-miss fallback, legacy scales files, and settings
  scoped to one call.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dd3d_tpu_torch.ops.int8_conv as int8_ops
from dd3d_tpu.models import layers as jl
from dd3d_tpu_torch.models import layers as pl
from dd3d_tpu_torch.ops.int8_conv import activation_scale, int8_conv, int8_conv_acc_plain, int8_conv_dequant
from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables

from tests.torch_port_util import to_torch_nchw, torch_threads

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads():
        yield


def _jax_int8_conv(x, kernel_hwio, stride, act_amax=None, out_dtype=jnp.float32):
    k = kernel_hwio.shape[0]
    p = (k - 1) // 2
    return np.asarray(jl._int8_conv(jnp.asarray(x), jnp.asarray(kernel_hwio), strides=(stride, stride),
                                    padding=[(p, p), (p, p)], rhs_dilation=(1, 1), groups=1, out_dtype=out_dtype,
                                    act_amax=act_amax))


def _port_int8_conv(x, kernel_hwio, stride, act_amax=None, dtype=torch.float32):
    k = kernel_hwio.shape[0]
    w = torch.from_numpy(np.ascontiguousarray(kernel_hwio.transpose(3, 2, 0, 1)))
    y = int8_conv_dequant(to_torch_nchw(x).to(dtype), w, None, stride, (k - 1) // 2, dtype, act_amax)
    return y.permute(0, 2, 3, 1).float().numpy()


def _jax_codes(x, act_amax):
    """The int8 codes `_int8_conv` gives x, read back through a 1x1 identity
    conv: with a weight of 127 * I every per-channel weight scale is 1 and
    the output is f32(127 * q) * (xs * 1), so q = round(y / (127 * xs))."""
    c = x.shape[-1]
    kernel = (np.eye(c, dtype=np.float32) * 127.0)[None, None]
    y = _jax_int8_conv(x.astype(np.float32), kernel, 1, act_amax)
    xs = np.maximum(np.float32(act_amax), np.float32(1e-12)) / np.float32(127)
    return np.rint(y / (np.float32(127) * xs)).astype(np.int8)


def test_quantize_codes_match_jax_ties_and_clip():
    """Exact .5 ties (xs = 15.875 / 127 = 0.125) round half to even, and
    |x / xs| > 127 clips, as in `_int8_conv`; dynamic and static scales."""
    rng = np.random.RandomState(0)
    x = ((rng.randint(-200, 200, size=(2, 5, 7, 8)) + 0.5) * 0.125).astype(np.float32)
    x[0, 0, 0, :4] = [0.0625, 0.1875, -0.0625, -0.1875]  # 0.5, 1.5, -0.5, -1.5 steps
    xt = torch.from_numpy(x)
    q = quantize_int8(xt, activation_scale(xt, 15.875)).numpy()
    np.testing.assert_array_equal(q, _jax_codes(x, 15.875))
    np.testing.assert_array_equal(q[0, 0, 0, :4], [0, 2, 0, -2])
    assert (np.abs(q) == 127).sum() > 50 and (np.abs(x / 0.125) > 127.5).sum() > 50
    # dynamic: the scale is max|x| / 127, the largest magnitude maps to +-127
    qd = quantize_int8(xt, activation_scale(xt, None)).numpy()
    np.testing.assert_array_equal(qd, _jax_codes(x, float(np.abs(x).max())))
    assert np.abs(qd).max() == 127


def test_quantize_divides_like_the_package_not_like_the_pallas_kernel():
    """The Pallas benchmark kernel multiplies by 1/xs
    (scripts/bench_quantize_kernel.py:93); the package divides by xs
    (layers.py:263). The two round to different codes where x / xs lies on
    or next to a .5 tie. The port divides: pin inputs where they differ."""
    xs = np.float32(0.0312)  # the benchmark's scale
    inv = np.float32(1.0 / 0.0312)  # its precomputed inverse
    ties = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * xs
    differ = ties[np.rint(ties / xs) != np.rint(ties * inv)]
    assert differ.size > 10
    x = differ.reshape(1, 1, -1, 1)
    q = quantize_int8(torch.from_numpy(x), torch.tensor([xs])).numpy().ravel()
    np.testing.assert_array_equal(q, np.rint(differ / xs))
    assert not np.any(q == np.rint(differ * inv))
    # e.g. x / xs == -125.5 exactly: half to even gives -126, x * inv -125
    assert differ[0] / xs == -125.5 and q[0] == -126 and np.rint(differ[0] * inv) == -125
    amax = float(xs * np.float32(127))
    assert np.float32(amax) / np.float32(127) == xs
    np.testing.assert_array_equal(q, _jax_codes(x, amax).ravel())


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("cin", [3, 16, 64])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_dequant_matches_jax_fp32_exactly(stride, k, cin, static):
    rng = np.random.RandomState(100 * k + cin + stride)
    x = rng.randn(2, 9, 11, cin).astype(np.float32)
    kernel = (rng.randn(k, k, cin, 12) * 0.2).astype(np.float32)
    amax = float(np.abs(x).max()) * 0.8 if static else None  # static: some clipping
    np.testing.assert_array_equal(_port_int8_conv(x, kernel, stride, amax), _jax_int8_conv(x, kernel, stride, amax))


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (7, 1)])
def test_int8_conv_dequant_matches_jax_bf16(k, stride):
    """bf16 in and out: within one bf16 ulp (XLA may keep the f32 product
    past its bf16 cast before the bias add; here there is no bias)."""
    rng = np.random.RandomState(7 + k)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    kernel = (rng.randn(k, k, 16, 24) * 0.2).astype(np.float32)
    y_j = _jax_int8_conv(jnp.asarray(x, jnp.bfloat16), kernel, stride, out_dtype=jnp.bfloat16).astype(np.float32)
    y_p = _port_int8_conv(np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), kernel, stride,
                          dtype=torch.bfloat16)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(y_j), 1e-30))) - 7)
    assert np.all(np.abs(y_p - y_j) <= ulp)


def test_int8_conv_accumulates_exactly_beyond_f32():
    """Sums past 2^24 (all codes 127, K = 3*3*512 = 4608: 74.3M) stay exact
    integers in the plain version; checked against int64 arithmetic."""
    xq = torch.full((1, 3, 3, 512), 127, dtype=torch.int8)
    wq = torch.full((2, 3, 3, 512), 127, dtype=torch.int8)
    wq[1, 0, 0, 0] = -127
    acc = int8_conv_acc_plain(xq, wq, 1, 1)
    assert acc.dtype == torch.int32
    assert int(acc[0, 1, 1, 0]) == 127 * 127 * 4608
    assert int(acc[0, 1, 1, 1]) == 127 * 127 * 4606


def test_int8_exactness_int_grid():
    """Activations and weights already on the int8 grid: the quantized conv
    equals the fp32 conv of the same operands (the JAX package's
    test_int8_exactness_int_grid, through the port)."""
    rng = np.random.RandomState(2)
    xi = rng.randint(-127, 128, size=(1, 8, 8, 4)).astype(np.float32)
    xi[0, 0, 0, 0] = 127.0
    wi = rng.randint(-127, 128, size=(3, 3, 4, 6)).astype(np.float32)
    wi[0, 0, 0, :] = 127.0
    y = _port_int8_conv(xi, wi / 127.0, 1)
    ref = torch.nn.functional.conv2d(to_torch_nchw(xi).double(),
                                     torch.from_numpy(wi.transpose(3, 2, 0, 1) / 127.0).double(), padding=1)
    np.testing.assert_allclose(y, ref.permute(0, 2, 3, 1).numpy(), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("c", [3, 12])
def test_channel_padding_leaves_the_conv_unchanged(c):
    """The wrapper pads C with zero channels to a multiple of 16 for the
    kernel's 16-byte chunks; the padded operands give the same outputs."""
    rng = np.random.RandomState(c)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 9, 11, c)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (5, 3, 3, c)).astype(np.int8))
    scale = torch.from_numpy((rng.rand(5) * 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.randn(5).astype(np.float32))
    xp, wp = int8_ops.pad_channels(xq, wq)
    assert xp.shape[3] == wp.shape[3] == 16 and not xp[..., c:].any() and not wp[..., c:].any()
    for stride in (1, 2):
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(int8_ops.int8_conv_plain(xp, wp, scale, bias, stride, 1, dt),
                               int8_ops.int8_conv_plain(xq, wq, scale, bias, stride, 1, dt))
    same = torch.zeros(1, 2, 2, 32, dtype=torch.int8)
    assert int8_ops.pad_channels(same, same)[0] is same


def test_wrappers_check_and_run_the_plain_version_on_the_cpu():
    x = torch.randn(1, 4, 4, 8)
    xs = activation_scale(x, None)
    before = quantize_int8.launches, int8_conv.launches
    q = quantize_int8(x, xs)
    assert torch.equal(q, quantize_int8_plain(x, xs))
    wq = torch.ones(5, 3, 3, 8, dtype=torch.int8)
    y = int8_conv(q, wq, torch.ones(5), None, 1, 1, torch.float32)
    assert y.shape == (1, 4, 4, 5)
    assert (quantize_int8.launches, int8_conv.launches) == before  # no kernel ran
    with pytest.raises(TypeError):
        quantize_int8(x.double(), xs)
    with pytest.raises(TypeError):
        int8_conv(q.float(), wq, torch.ones(5), None, 1, 1, torch.float32)
    with pytest.raises(ValueError):
        int8_conv(q, wq, torch.ones(4), None, 1, 1, torch.float32)


# ---- the quant branches of the layers against the flax modules ----------

def _randomize(tree, rng):
    def leaf(path, x):
        if path[-1].key == "var":
            return (rng.rand(*x.shape) * 0.5 + 0.5).astype(np.float32)
        return (rng.randn(*x.shape) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def _jax_quant(monkeypatch, enabled, min_ch, unfolded, scales=None):
    monkeypatch.setattr(jl, "QUANT_INT8", enabled)
    monkeypatch.setattr(jl, "QUANT_MIN_CH", min_ch)
    monkeypatch.setattr(jl, "QUANT_UNFOLDED", unfolded)
    monkeypatch.setattr(jl, "QUANT_SCALES", scales or {})
    monkeypatch.setattr(jl, "QUANT_OBSERVED_TAGS", {})
    monkeypatch.setattr(jl, "QUANT_SCALE_MISSES", [])


@contextlib.contextmanager
def _recorded_int8_convs():
    """Record each int8 conv the layers run: (xq, wq, scale, bias, stride,
    pad, output)."""
    calls, real = [], int8_ops.int8_conv

    def record(xq, wq, scale, bias, stride, pad, out_dtype):
        out = real(xq, wq, scale, bias, stride, pad, out_dtype)
        calls.append((xq, wq, scale, bias, stride, pad, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_ops, "int8_conv", record)
        yield calls


def _assert_written_dequant(call):
    """The port's f32 int8 conv bit for bit against the dequant as
    layers.py:276 and :364-365 write it, in numpy: f32(acc) * scale rounded,
    then + bias rounded, over the port's exact im2col accumulators. Returns
    one ulp of the largest pre-rounding magnitude, 2^-23 * max(|acc * scale|
    + |bias|): jitted XLA:CPU contracts f32(acc) * scale + bias into one FMA
    with a single rounding on some hosts and not on others, so JAX's result
    may sit that far from the written arithmetic."""
    xq, wq, scale, bias, stride, pad, out = call
    acc = int8_conv_acc_plain(xq, wq, stride, pad).numpy()
    scale = scale.detach().numpy()
    y = acc.astype(np.float32) * scale
    mag = np.abs(acc * scale.astype(np.float64))
    if bias is not None:
        bias = bias.detach().numpy()
        y = y + bias
        mag = mag + np.abs(bias)
    assert y.dtype == np.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), y)
    return 2.0 ** -23 * float(mag.max())


def _check(port_q, port_fp, jax_q, calls, quantizes, exact=True):
    """Both sides quantize or neither does (fp32 conv, 1e-5). Where both
    quantize, the port's one int8 conv (`calls`) is pinned bit for bit to
    the written two-rounding dequant, and the layer's output is within one
    ulp of JAX's (1e-5 where `exact` is off)."""
    if quantizes:
        assert not np.array_equal(port_q, port_fp), "the int8 branch should have engaged"
        assert len(calls) == 1
        ulp = _assert_written_dequant(calls[0])
        if exact:
            np.testing.assert_allclose(port_q, jax_q, rtol=0, atol=ulp)
        else:
            np.testing.assert_allclose(port_q, jax_q, **TOL)
    else:
        assert calls == []
        np.testing.assert_array_equal(port_q, port_fp)
        np.testing.assert_allclose(port_q, jax_q, **TOL)


@pytest.mark.parametrize("unfolded", [False, True], ids=["folded_only", "unfolded"])
@pytest.mark.parametrize("min_ch", [0, 16])
@pytest.mark.parametrize("norm", ["FrozenBN", "BN", ""])
def test_conv_norm_quant_branch(monkeypatch, norm, min_ch, unfolded):
    """Eligible: a folded norm, or any conv under QUANT_UNFOLDED; then the
    input must have C >= QUANT_MIN_CH (8 channels here). Exact, except that
    live BN folds with rsqrt, where jax.lax.rsqrt and torch.rsqrt differ by
    an ulp on the CPU: the folded weights, their scales and the bias then
    differ in the last bit (1e-5)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 10, 8).astype(np.float32)
    jm = jl.ConvNorm(16, 3, 2, norm=norm, activation=jax.nn.relu, dtype=jnp.float32)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    _jax_quant(monkeypatch, True, min_ch, unfolded)
    y_j = np.asarray(jm.apply(variables, jnp.asarray(x)))

    pm = pl.ConvNorm(8, 16, 3, 2, norm=norm, relu=True).eval()
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    pm.quant_path = "conv"
    xt = to_torch_nchw(x)
    with torch.no_grad():
        y_fp = pm(xt).permute(0, 2, 3, 1).numpy()
        with pl.quant_scope(pl.QuantSpec(enabled=True, min_ch=min_ch, unfolded=unfolded)) as spec, \
                _recorded_int8_convs() as calls:
            y_q = pm(xt).permute(0, 2, 3, 1).numpy()
    quantizes = (norm != "" or unfolded) and 8 >= min_ch
    _check(y_q, y_fp, y_j, calls, quantizes, exact=norm != "BN")
    assert spec.misses == [] and spec.capture is None


@pytest.mark.parametrize("min_ch", [0, 1000])
def test_tower_conv_quant_branch(monkeypatch, min_ch):
    """One shared kernel, each level's norm folded into its own int8 conv."""
    rng = np.random.RandomState(3)
    levels, c = 3, 8
    xs = [rng.randn(2, 8 >> l, 10 >> l, c).astype(np.float32) for l in range(levels)]

    class Tower(jl.nn.Module):
        @jl.nn.compact
        def __call__(self, xs):
            conv = jl.FoldableConv(c, kernel_size=3, dtype=jnp.float32, name="conv")
            norms = jl.PerLevelNorms(levels, c, "FrozenBN", dtype=jnp.float32, name="norms")
            return [jax.nn.relu(conv(x, *norms(None, l, False, fold_query=True))) for l, x in enumerate(xs)]

    jm = Tower()
    variables = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]), rng)
    _jax_quant(monkeypatch, True, min_ch, False)
    outs_j = jm.apply(variables, [jnp.asarray(x) for x in xs])

    tower = pl.TowerConv(c, levels, "FrozenBN").eval()
    tower.quant_path = "conv"
    with torch.no_grad():
        tower.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        for l in range(levels):
            stats = variables["batch_stats"]["norms"][f"norm{l}"]
            nm = tower.norm[l]
            for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                                 ("running_var", "var")):
                getattr(nm, ours).copy_(torch.from_numpy(np.asarray(stats[theirs])))
        for l, (x, y_j) in enumerate(zip(xs, outs_j)):
            xt = to_torch_nchw(x)
            y_fp = tower(xt, l).permute(0, 2, 3, 1).numpy()
            with pl.quant_scope(pl.QuantSpec(enabled=True, min_ch=min_ch)), _recorded_int8_convs() as calls:
                y_q = tower(xt, l).permute(0, 2, 3, 1).numpy()
            _check(y_q, y_fp, np.asarray(y_j), calls, min_ch == 0)


@pytest.mark.parametrize("unfolded", [False, True], ids=["folded_only", "unfolded"])
def test_fused_predictors_quant_branch(monkeypatch, unfolded):
    """Norm-free predictors quantize only under QUANT_UNFOLDED, and then
    whatever QUANT_MIN_CH is (the JAX quirk at layers.py:474, matched):
    min_ch here is far above the 16 input channels."""
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
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    _jax_quant(monkeypatch, True, 10 ** 6, unfolded)
    outs_j = jm.apply(variables, jnp.asarray(x))

    preds = [pl.PredictorConv(16, f, bias=b) for f, b in specs]
    for i, p in enumerate(preds):
        p.load_state_dict(convert_flax_variables({"params": variables["params"][f"p{i}"]}, p), strict=True)
    preds[0].quant_path = "p0"
    xt = to_torch_nchw(x)
    with torch.no_grad():
        outs_fp = pl.fused_predictor_apply(xt, preds)
        with pl.quant_scope(pl.QuantSpec(enabled=True, min_ch=10 ** 6, unfolded=unfolded, capture=[])) as spec, \
                _recorded_int8_convs() as calls:
            outs_q = pl.fused_predictor_apply(xt, preds)
    for oj, oq, of in zip(outs_j, outs_q, outs_fp):
        _check(oq.permute(0, 2, 3, 1).numpy(), of.permute(0, 2, 3, 1).numpy(), np.asarray(oj), calls, unfolded)
    # capture keys the group by its first sibling, with the NHWC shape tag
    assert [(p, t) for p, t, _ in spec.capture] == ([("p0", "6x7x16")] if unfolded else [])


def test_p6p7_never_quantize():
    """The JAX package builds P6/P7 as plain nn.Conv, which its int8 rule
    never reaches; the port's P6/P7 must stay fp even with every gate open."""
    from dd3d_tpu_torch.models.fpn import LastLevelP6P7

    top = LastLevelP6P7(16).eval()
    x = torch.randn(2, 16, 8, 12).to(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = top(x)
        with pl.quant_scope(pl.QuantSpec(enabled=True, min_ch=0, unfolded=True, capture=[])) as spec:
            out = top(x)
    assert all(torch.equal(a, b) for a, b in zip(ref, out))
    assert spec.capture == []
    assert not top.p6.quantizable and not top.p7.quantizable


# ---- the quant state on the port's model ----------------------------------

@pytest.fixture(scope="module")
def small_model():
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models import build_model

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy((np.random.RandomState(1).rand(1, 128, 128, 3) * 255).astype(np.uint8))
    return cfg, model, images


def _forward(model, images, **spec_kw):
    spec = pl.QuantSpec(enabled=True, min_ch=0, unfolded=True, **spec_kw)
    with torch.no_grad(), pl.quant_scope(spec):
        out = model(images)
    return out, spec


def _captured(spec):
    scales = {}
    for path, tag, amax in spec.capture:
        scales.setdefault(path, {})[tag] = max(float(amax), scales.get(path, {}).get(tag, 0.0))
    return scales


def _assert_same(a, b):
    for key in a:
        for lvl, (x, y) in enumerate(zip(a[key], b[key])):
            assert torch.equal(x, y), f"{key}[{lvl}]"


def test_static_scales_equal_dynamic_and_misses_fall_back(small_model):
    """Scales captured on a batch reproduce the dynamic result on that batch
    bit for bit; scales under tags that were never calibrated (another
    canvas) miss, are recorded, and fall back to the dynamic scale; a file
    with only some convs runs the rest dynamically."""
    _, model, images = small_model
    dyn, spec = _forward(model, images, capture=[])
    scales = _captured(spec)
    assert len(scales) == 58  # every eligible conv of DLA-34 + FPN + heads

    static, spec = _forward(model, images, scales=scales)
    assert spec.misses == []
    _assert_same(dyn, static)

    wrong = {k: {f"9{t}": a for t, a in v.items()} for k, v in scales.items()}
    out, spec = _forward(model, images, scales=wrong)
    assert {p for p, _ in spec.misses} == set(scales)
    _assert_same(dyn, out)

    partial = dict(sorted(scales.items())[::2])
    out, spec = _forward(model, images, scales=partial)
    assert {p for p, _ in spec.misses} == set(scales) - set(partial)
    _assert_same(dyn, out)

    quartered = {k: {t: a * 4.0 for t, a in v.items()} for k, v in scales.items()}
    out, _ = _forward(model, images, scales=quartered)
    assert not torch.equal(out["logits"][0], dyn["logits"][0])  # the static scales are really used


def test_legacy_scales_file_converts_or_rejects(tmp_path):
    p = tmp_path / "legacy.json"
    p.write_text(json.dumps({"a/conv": [1.0, 2.0], "__tags__": {"a/conv": ["4x4x8", "2x2x8"]}}))
    assert pl.load_quant_scales(str(p)) == {"a/conv": {"4x4x8": 1.0, "2x2x8": 2.0}}
    assert pl.load_quant_scales(str(p)) == jl.load_quant_scales(str(p))
    q = tmp_path / "untagged.json"
    q.write_text(json.dumps({"a/conv": [1.0, 2.0]}))
    with pytest.raises(ValueError, match="recalibrate"):
        pl.load_quant_scales(str(q))


def test_quant_config_key_routes_through_inference_cache(small_model):
    """Two inference functions from one model, with configs that differ only
    in the quant keys, each keep their own setting, called in any order
    (the port of tests/test_int8_infer.py's test of the same name)."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    cfg_off, model, images = small_model
    cfg_on = cfg_off.clone()
    cfg_on.TPU.QUANT_INT8 = True
    cfg_on.TPU.QUANT_MIN_CH = 0
    intr = np.tile(np.array([[120.0, 0, 64.0], [0, 120.0, 64.0], [0, 0, 1]], np.float32), (1, 1, 1))
    fn_off, fn_on = get_inference_fn(model, cfg_off), get_inference_fn(model, cfg_on)
    assert fn_off is not fn_on
    a = fn_off(images, intr)["scores"]
    b = fn_on(images, intr)["scores"]
    a2 = fn_off(images, intr)["scores"]
    assert torch.equal(a, a2)
    assert not torch.equal(a, b)
    assert not pl._QUANT.get().enabled  # nothing leaks out of a call
