"""dd3d_kitti_regnety_006_bifpn (RegNetY-006 + BiFPN at P3-P7 + the DD3D
heads) in the port against the JAX package, on the CPU in fp32:

- `generate_regnet_params` against JAX's at every preset and the published
  RegNetY table (tests/test_regnet_bifpn.py:18-30);
- BiFPN's 3x3/s2 SAME max-pool on even and odd sides against flax's
  `nn.max_pool`: an even side pads 0 before and 1 after;
- the feature extractor's P3-P7 and all 8 head outputs of the full DD3D
  forward at 128x128, batch 2, BiFPN 64 channels x 1 repeat, RegNetY-006
  at full width and depth, within atol = rtol = 1e-4 (as
  tests/test_torch_model.py), with the same seeded weights through
  `convert_flax_variables` (LeCun-scaled kernels keep the features of
  order one through the 15 residual blocks);
- the grouped int8 conv's plain version against JAX's `_int8_conv` with
  feature_group_count g in {3, 160}: accumulators bit for bit, the dequant
  bit for bit to its written arithmetic and within 2^-23 * max(|acc *
  scale| + |bias|) of JAX's (tests/test_torch_int8.py's bound);
- static int8 in bench.py's settings (QUANT_INT8, QUANT_MIN_CH 32,
  QUANT_UNFOLDED): the calibrated scale keys and tags equal to JAX's
  `prepare_static_scales` over the two images, every grouped site (`b`,
  `dw`) among them, the maxima within 5e-2 (tests/test_torch_calibrate.py's
  bound; the calibration forward runs int8 with dynamic scales, where a code
  that flips at a rounding tie upstream moves a site's maximum: 3.8e-2 at
  worst here, at the 8x8 tower convs);
- the weight-decay mask equal to JAX's, and a reference-named checkpoint
  refused with its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg as jax_experiment
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.models import layers as jl
from dd3d_tpu.models.bifpn import _maxpool_s2 as jax_maxpool_s2
from dd3d_tpu.models.calibrate import prepare_static_scales as jax_prepare_static_scales
from dd3d_tpu.models.layers import load_quant_scales as jax_load_quant_scales
from dd3d_tpu.models.regnet import REGNETY_SPECS as JAX_SPECS, generate_regnet_params as jax_generate
from dd3d_tpu.training.optim import _wd_mask
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.bifpn import maxpool_s2
from dd3d_tpu_torch.models.calibrate import prepare_static_scales
from dd3d_tpu_torch.models.dd3d import HEAD_KEYS_2D, HEAD_KEYS_3D
from dd3d_tpu_torch.models.layers import load_quant_scales
from dd3d_tpu_torch.models.regnet import REGNETY_SPECS, generate_regnet_params
from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv_grouped_acc_plain, int8_conv_grouped_plain
from dd3d_tpu_torch.training import optim as popt
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables, flax_param_paths

from tests.torch_port_util import jax_quant_globals_restored, torch_threads

HEAD_KEYS = HEAD_KEYS_2D + HEAD_KEYS_3D
EXPERIMENT = "dd3d_kitti_regnety_006_bifpn"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def small_cfg(get=get_experiment_cfg):
    """The experiment at fp32 with BiFPN 64 x 1 (the trunk at full width)."""
    cfg = get(EXPERIMENT)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.FE.BIFPN.OUT_CHANNELS = 64
    cfg.FE.BIFPN.NUM_REPEATS = 1
    return cfg


def seeded_variables(shapes, seed):
    """JAX variables of `shapes` drawn from `seed`: LeCun-scaled conv kernels,
    norm scales about 1, biases, means and variances as
    tests/torch_port_util.seed_flax_variables draws them, and fusion weights
    in [-0.2, 1.3] (some of them cut by the relu)."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1]
        if name == "kernel":
            return rng.randn(*s.shape) * np.sqrt(1.0 / np.prod(s.shape[:3]))
        if name == "w":
            return rng.rand(*s.shape) * 1.5 - 0.2
        if name == "scale":
            return 1.0 + rng.randn(*s.shape) * 0.1
        if name == "var":
            return rng.rand(*s.shape) + 0.5
        return rng.randn(*s.shape) * 0.1

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw([getattr(k, "key", k) for k in p], s), np.float32), shapes)


def test_regnet_params_match_jax_and_the_published_table():
    assert set(REGNETY_SPECS) == set(JAX_SPECS) and REGNETY_SPECS == JAX_SPECS
    for spec in REGNETY_SPECS.values():
        assert generate_regnet_params(*spec[:5]) == jax_generate(*spec[:5])
    assert generate_regnet_params(*REGNETY_SPECS["RegNetY-006"][:5]) == ((48, 112, 256, 608), (1, 3, 7, 4),
                                                                         (16, 16, 16, 16))
    widths, depths, _ = generate_regnet_params(*REGNETY_SPECS["RegNetY-004"][:5])
    assert widths == (48, 104, 208, 440) and depths == (1, 3, 6, 6)


@pytest.mark.parametrize("h,w", [(6, 20), (3, 10), (7, 9), (1, 1), (48, 160)])
def test_maxpool_s2_matches_flax_same(h, w):
    x = np.random.RandomState(h * w).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(jax_maxpool_s2(jnp.asarray(x)))
    got = maxpool_s2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-h // 2), -(-w // 2), 5)
    np.testing.assert_array_equal(got, want)
    if h % 2 == 0 and h > 2:  # the asymmetric pad: torch's padding=1 picks other windows
        other = torch.nn.functional.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
        assert not np.array_equal(other.permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def forward():
    cfg_j, cfg_p = small_cfg(jax_experiment), small_cfg()
    jm = build_jax_model(cfg_j)
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    variables = seeded_variables(shapes, 11)
    pm = build_model(cfg_p)
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    images = (np.random.RandomState(3).rand(2, 128, 128, 3) * 255).astype(np.uint8)

    def apply(v, x):
        out, inter = jm.apply(v, x, train=False, capture_intermediates=lambda m, _: m.name == "backbone")
        return out, inter["intermediates"]["backbone"]["__call__"][0]

    out_j, feats_j = jax.jit(apply)(variables, jnp.asarray(images))
    feats_p = {}
    hook = pm.backbone.register_forward_hook(lambda m, i, o: feats_p.update(o))
    with torch.no_grad():
        out_p = pm(torch.from_numpy(images))
    hook.remove()
    return dict(cfg_j=cfg_j, jm=jm, variables=variables, pm=pm, images=images, out_j=out_j, out_p=out_p,
                feats_j=feats_j, feats_p=feats_p)


def test_feature_extractor_matches_jax(forward):
    fj, fp = forward["feats_j"], forward["feats_p"]
    assert list(fp) == ["p3", "p4", "p5", "p6", "p7"] and set(fj) == set(fp)
    assert forward["pm"].backbone.size_divisibility == 128
    for k in fp:
        s = forward["pm"].backbone.out_feature_strides[k]
        assert fp[k].shape == (2, 64, 128 // s, 128 // s), k
        want = np.asarray(fj[k]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(fp[k].numpy(), want, atol=1e-4, rtol=1e-4, err_msg=k)
        assert np.abs(want).max() > 0.1, k


@pytest.mark.parametrize("key", HEAD_KEYS)
def test_head_output_matches_jax(forward, key):
    out_j, out_p = forward["out_j"], forward["out_p"]
    assert len(out_p[key]) == len(out_j[key]) == 5
    for lvl, (p, j) in enumerate(zip(out_p[key], out_j[key])):
        assert p.shape == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4, err_msg=f"{key} level {lvl}")


def test_weight_decay_mask_and_names_match_jax(forward):
    pm, params = forward["pm"], forward["variables"]["params"]
    flat = {"/".join(str(p.key) for p in k): bool(v)
            for k, v in jax.tree_util.tree_leaves_with_path(_wd_mask(params, True))}
    paths = flax_param_paths(pm)
    assert {"/".join(p) for p in paths.values()} == set(flat)
    mask = popt.weight_decay_mask(pm, True)
    assert {n for n, m in mask.items() if not m} == {n for n, p in paths.items() if not flat["/".join(p)]}
    assert paths["backbone.cell0.p6_td_w.w"] == ("backbone", "cell0", "p6_td_w", "w")
    assert paths["backbone.bottom_up.s1_b0.se.fc1.weight"] == ("backbone", "bottom_up", "s1_b0", "se", "fc1",
                                                               "kernel")
    assert mask["backbone.cell0.p6_td_conv.dw.weight"] and mask["backbone.cell0.p6_td_w.w"]


def test_reference_checkpoint_is_refused(forward, tmp_path):
    from dd3d_tpu_torch.training.checkpoint import load_weights

    path = str(tmp_path / "model.pth")
    torch.save(forward["pm"].state_dict(), path)
    with pytest.raises(ValueError, match="no reference checkpoint"):
        load_weights(forward["pm"], path)


@pytest.mark.parametrize("c,g,o,stride", [(48, 3, 48, 2), (160, 160, 160, 1), (24, 3, 48, 1)])
def test_grouped_int8_conv_matches_jax(c, g, o, stride):
    """The plain grouped int8 conv against `_int8_conv(groups=g)`: RegNet's
    C/g = 16 at stride 2, BiFPN's depthwise, two outputs a group."""
    rng = np.random.RandomState(c + g)
    x = rng.randn(2, 9, 11, c).astype(np.float32)
    kernel = (rng.randn(3, 3, c // g, o) * 0.2).astype(np.float32)
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
    written = acc_j.astype(np.float32) * (np.float32(xs) * ws) + bias
    np.testing.assert_array_equal(out.numpy(), written)
    y_j = np.asarray(jl._int8_conv(jnp.asarray(x), jnp.asarray(kernel), strides=(stride, stride),
                                   padding=[(1, 1), (1, 1)], rhs_dilation=(1, 1), groups=g,
                                   out_dtype=jnp.float32)) + bias
    ulp = 2.0 ** -23 * float((np.abs(acc_j * (np.float64(xs) * ws)) + np.abs(bias)).max())
    assert np.abs(out.numpy() - y_j).max() <= ulp
    assert torch.equal(dequant_plain(acc, scale, None, torch.bfloat16),
                       int8_conv_grouped_plain(xq_t, wq_t, scale, None, stride, 1, torch.bfloat16, g))


def test_static_int8_scale_keys_match_jax(forward):
    """bench.py's settings on this model: every eligible conv's scale key
    and tag as JAX's calibration writes them, the grouped sites included."""
    cfg = small_cfg()
    cfg.TPU.QUANT_INT8, cfg.TPU.QUANT_MIN_CH, cfg.TPU.QUANT_UNFOLDED = True, 32, True
    cfg_jax = small_cfg(jax_experiment)
    cfg_jax.TPU.QUANT_INT8, cfg_jax.TPU.QUANT_MIN_CH, cfg_jax.TPU.QUANT_UNFOLDED = True, 32, True
    images = forward["images"]
    with jax_quant_globals_restored():
        cfg_j = jax_prepare_static_scales(cfg_jax, forward["jm"], forward["variables"], [jnp.asarray(images)],
                                          tag="regnetytest")
    cfg_p = prepare_static_scales(cfg, forward["pm"], [images], tag="regnetytest")
    sj, sp = jax_load_quant_scales(cfg_j.TPU.QUANT_SCALES_PATH), load_quant_scales(cfg_p.TPU.QUANT_SCALES_PATH)
    assert set(sp) == set(sj) and all(set(sp[k]) == set(sj[k]) for k in sj)
    assert "backbone/bottom_up/s1_b0/b/conv" in sp and "backbone/cell0/p3_out_conv/dw" in sp
    assert "backbone/cell0/p3_out_conv/pw/conv" in sp and "backbone/proj_s2/conv" in sp
    assert not any("/se/" in k for k in sp)  # flax nn.Convs never quantize
    rel = max(abs(sp[k][t] - sj[k][t]) / sj[k][t] for k in sj for t in sj[k])
    assert rel < 5e-2, rel
