"""The port of the stem weight-gradient kernel (dd3d_tpu_torch/ops/conv_dw.py)
against the JAX package's Pallas kernel (dd3d_tpu/ops/pallas_conv.py), run
in interpret mode on the CPU as tests/test_pallas_conv.py runs it; fp32.

- the plain dW against conv_dw_s1_same_pallas at the shapes of
  test_pallas_conv.py, to its tolerance (rtol 2e-5, atol 2e-4: two f32
  reductions over a few thousand products in other orders);
- Conv2dS1Same's value, dx and dW against the conv2d_s1_same custom_vjp;
- the whole stem: the port's DLA-34 with TPU.PALLAS_STEM_DW in train mode,
  live BN, against JAX's DLA(s2d_stem=True, pallas_stem_dw=True) at 64x64,
  where the JAX side really reaches the Pallas kernel: loss, every
  gradient, and the BN running statistics.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 10); here the wrapper takes the plain version because
its tensors lie on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.models.dla import DLA as JaxDLA, BasicBlock
from dd3d_tpu.ops.pallas_conv import conv2d_s1_same, conv_dw_s1_same_pallas
from dd3d_tpu_torch.models.dla import DLA
from dd3d_tpu_torch.ops.conv_dw import Conv2dS1Same, conv_dw_s1_same, conv_dw_s1_same_plain, pad_operands
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_params, convert_flax_variables

from tests.torch_port_util import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads():
        yield


def nchw_cl(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> an NCHW tensor with channels_last strides (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape,k,co", [((2, 16, 24, 12), 5, 16), ((2, 16, 24, 8), 3, 8), ((1, 8, 16, 4), 7, 4)])
def test_plain_dw_matches_pallas(shape, k, co):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    dy = rng.randn(shape[0], shape[1], shape[2], co).astype(np.float32)
    want = np.asarray(conv_dw_s1_same_pallas(jnp.asarray(x), jnp.asarray(dy), k, interpret=True))  # (k, k, CI, CO)
    got = conv_dw_s1_same_plain(nchw_cl(x), nchw_cl(dy), k)
    assert got.shape == (co, shape[3], k, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, rtol=2e-5, atol=2e-4)
    before = conv_dw_s1_same.launches
    assert torch.equal(conv_dw_s1_same(nchw_cl(x), nchw_cl(dy), k), got)  # CPU tensors: the plain version
    assert conv_dw_s1_same.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError, match="odd k"):
        conv_dw_s1_same(x, torch.zeros(1, 4, 8, 8), 4)
    with pytest.raises(ValueError, match="odd k"):
        conv_dw_s1_same(x, torch.zeros(1, 4, 8, 8), 11)
    with pytest.raises(TypeError, match="one dtype"):
        conv_dw_s1_same(x.bfloat16(), torch.zeros(1, 4, 8, 8), 3)
    with pytest.raises(ValueError, match="need x"):
        conv_dw_s1_same(x, torch.zeros(1, 4, 8, 9), 3)


@pytest.mark.parametrize("w,ci,co,offset", [(13, 3, 7, 0), (20, 5, 16, 0), (11, 16, 12, 1), (32, 3, 16, 8)])
def test_operand_padding_leaves_the_dw_unchanged(w, ci, co, offset):
    """The tensor-core path's padding (W*CI and CO to multiples of 8, an
    input at an unaligned offset copied) gives the same dW, bit for bit:
    small integer values, so every f32 sum is exact in any order."""
    rng = np.random.RandomState(w + ci)
    b, h, k = 2, 9, 5
    xs = torch.from_numpy(rng.randint(-3, 4, b * h * w * ci + offset).astype(np.float32)).bfloat16()
    x = xs[offset:].view(b, h, w, ci).permute(0, 3, 1, 2)  # channels_last, `offset` elements into its storage
    dy = nchw_cl(rng.randint(-3, 4, (b, h, w, co)).astype(np.float32)).bfloat16()
    xp, dyp = pad_operands(x, dy)
    assert xp.shape[3] * ci % 8 == 0 and dyp.shape[1] % 8 == 0 and xp.shape[3] == dyp.shape[3]
    assert xp.data_ptr() % 16 == 0 and dyp.data_ptr() % 16 == 0
    cl = torch.channels_last
    assert xp.is_contiguous(memory_format=cl) and dyp.is_contiguous(memory_format=cl)
    assert not xp[..., w:].any() and not dyp[..., w:].any() and not dyp[:, co:].any()
    assert torch.equal(conv_dw_s1_same_plain(xp, dyp, k)[:co], conv_dw_s1_same_plain(x, dy, k))
    if (w * ci % 8, co % 8, offset % 8) == (0, 0, 0):
        assert pad_operands(x, dy) == (x, dy)  # nothing to pad, nothing copied


def excess_over_tolerance(got, want, rtol, atol):
    """max(|got - want| / (atol + rtol |want|)): at most 1 where
    np.testing.assert_allclose(got, want, rtol, atol) passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def test_conv2d_s1_same_matches_custom_vjp():
    """Value, dx and dW of sum(sin(conv)) through the port's Conv2dS1Same and
    through JAX's custom_vjp with the Pallas dW in interpret mode, each held
    to an f64 oracle (torch's f64 conv and autograd) at the tolerances of
    the two sides' old direct comparison: value rtol 1e-5; dx and dW rtol
    2e-5, atol 2e-4. Every message gives both sides' distances, so a failure
    names the side that is off. JAX's side is compiled here, for this host's
    CPU, with the persistent compilation cache off."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 24, 12).astype(np.float32)
    wt = (rng.randn(5, 5, 12, 16) * 0.1).astype(np.float32)  # HWIO

    x64 = torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2).requires_grad_(True)
    w64 = torch.from_numpy(wt.astype(np.float64).transpose(3, 2, 0, 1)).requires_grad_(True)
    v64 = torch.sin(torch.nn.functional.conv2d(x64, w64, padding=2)).sum()
    v64.backward()
    oracle = {"value": float(v64.detach()), "dx": x64.grad.permute(0, 2, 3, 1).numpy(),
              "dW": w64.grad.permute(2, 3, 1, 0).numpy()}

    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        va, (gxa, gwa) = jax.value_and_grad(lambda x, w: jnp.sum(jnp.sin(conv2d_s1_same(x, w, True))),
                                            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
    jax_side = {"value": float(va), "dx": np.asarray(gxa), "dW": np.asarray(gwa)}

    xt = nchw_cl(x).requires_grad_(True)
    w = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))).requires_grad_(True)
    vb = torch.sin(Conv2dS1Same.apply(xt, w)).sum()
    vb.backward()
    port = {"value": float(vb.detach()), "dx": xt.grad.permute(0, 2, 3, 1).numpy(),
            "dW": w.grad.permute(2, 3, 1, 0).numpy()}

    tol = {"value": (1e-5, 0.0), "dx": (2e-5, 2e-4), "dW": (2e-5, 2e-4)}
    excess = {side: {k: excess_over_tolerance(got[k], oracle[k], *tol[k]) for k in oracle}
              for side, got in (("port", port), ("JAX", jax_side))}
    report = "; ".join(f"{k}: port {excess['port'][k]:.3g}, JAX {excess['JAX'][k]:.3g}" for k in oracle)
    report = f"distance from the f64 oracle, in units of the tolerance (pass <= 1): {report}"
    for k in oracle:
        assert excess["port"][k] <= 1.0, f"the port's {k} is off. {report}"
    for k in oracle:
        assert excess["JAX"][k] <= 1.0, f"JAX's {k} is off. {report}"


def test_conv2d_s1_same_skips_dx_of_the_image():
    """No dx for an input that needs no gradient (the image), and a bf16
    weight gets a bf16 gradient, as JAX casts dW to the weight's dtype."""
    x = torch.randn(1, 3, 10, 12).to(memory_format=torch.channels_last).bfloat16()
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    y = Conv2dS1Same.apply(x, w.to(torch.bfloat16))
    wb = torch.randn(4, 3, 3, 3, dtype=torch.bfloat16, requires_grad=True)
    (gw_b,) = torch.autograd.grad(Conv2dS1Same.apply(x, wb).float().sum(), [wb])
    assert gw_b.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32 and x.grad is None


STEM_LEVELS, STEM_CHANNELS = [1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512]


@pytest.fixture(scope="module")
def stem_case():
    """JAX s2d stem with the Pallas dW (interpret mode) and the port's plain
    stem with the kernel route, one train-mode forward/backward of
    sum(level1^2) on the same 64x64 batch, BN everywhere."""
    kw = dict(levels=STEM_LEVELS, channels=STEM_CHANNELS, block=BasicBlock, out_features=("level1",), norm="BN",
              dtype=jnp.float32)
    jm = JaxDLA(s2d_stem=True, pallas_stem_dw=True, **kw)
    x = (np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 10 - 5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    rng = np.random.RandomState(3)
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(lambda a: (rng.rand(*a.shape) * 0.5 + 0.5).astype(np.float32),
                                               v["batch_stats"])}

    def loss(params):
        out, new_state = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        return jnp.sum(out["level1"] ** 2), new_state["batch_stats"]

    (lj, stats_j), gj = jax.value_and_grad(loss, has_aux=True)(v["params"])

    pm = DLA(STEM_LEVELS, STEM_CHANNELS, out_features=("level1",), norm="BN", kernel_stem_weight_grad=True)
    pm.load_state_dict(convert_flax_variables(v, pm), strict=True)
    pm.train()
    before = conv_dw_s1_same.launches
    lp = (pm(nchw_cl(x))["level1"] ** 2).sum()
    lp.backward()
    return dict(jm=jm, pm=pm, lj=float(lj), lp=float(lp.detach()), gj=convert_flax_params(gj, pm),
                stats_j=convert_flax_variables({"params": v["params"], "batch_stats": stats_j}, pm),
                dw_calls=conv_dw_s1_same.launches - before)


def test_stem_loss_matches(stem_case):
    np.testing.assert_allclose(stem_case["lp"], stem_case["lj"], rtol=1e-5)


def test_stem_gradients_match(stem_case):
    """Every parameter's gradient, each relative to its largest magnitude
    (tolerance 1e-4: f32 on both sides, the s2d rewrite and the plain stem
    sum in other orders through BN's batch statistics)."""
    pm, gj = stem_case["pm"], stem_case["gj"]
    stem = [n for n in gj if n.startswith(("base_layer", "level0", "level1"))]
    assert "base_layer.weight" in stem and "level0.0.weight" in stem
    for name, p in pm.named_parameters():
        want = gj[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()  # levels 2-5 do not reach the loss
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-4, err_msg=name)
        if name in stem:
            assert np.abs(want).max() > 0, name


def test_stem_bn_running_stats_match(stem_case):
    pm, stats_j = stem_case["pm"], stem_case["stats_j"]
    for name, t in pm.state_dict().items():
        if name.endswith(("running_mean", "running_var")) and name.startswith(("base_layer", "level0", "level1")):
            np.testing.assert_allclose(t.numpy(), stats_j[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def test_stem_routes_only_its_stride1_convs(stem_case):
    """base_layer and level0 take the kernel route, level1's stride-2 conv
    does not; on the CPU the route runs the plain dW, so no launch counts."""
    pm = stem_case["pm"]
    routed = sorted(n for n, m in pm.named_modules() if getattr(m, "kernel_weight_grad", False))
    assert routed == ["base_layer", "level0.0"]
    assert stem_case["dw_calls"] == 0
    with pytest.raises(ValueError, match="stride"):
        pm.level1[0].route_weight_grad()
