"""The head options DD3D.FCOS2D._VERSION=v1 (a tower conv with a bias before
the per-level norm), DD3D.FCOS3D.PER_LEVEL_PREDICTORS (five predictors a
level, `box3d_*{l}`) and DD3D.FCOS3D.CLASS_AGNOSTIC_BOX3D (one 3D box a
location) in the port against the JAX package, on the CPU:

- the whole DD3D forward with all three options on (DLA-34, FPN 64, 128x128,
  batch 2, fp32, the same seeded weights through `convert_flax_variables`):
  every head output at every level within atol = rtol = 1e-4, as
  tests/test_torch_model.py; the flax paths of the new parameters (the
  towers' biases, the per-level predictors) are JAX's;
- the decode (`dd3d_inference`) with class-agnostic 3D maps against JAX's
  on random head outputs: valid masks, classes and levels equal, every field
  within 1e-5, as tests/test_torch_decode.py;
- the losses with class-agnostic 3D maps against JAX's `dd3d_losses` on
  the cases of tests/test_loss_parity.py: every loss within rtol 1e-5, and
  the gradient of the total loss with respect to each 3D map within 1e-5 of
  its largest value, as tests/test_torch_losses.py;
- static int8 (small heads, 16 channels, all options on, scales calibrated
  on the features): the fused tower links (the v1 bias folded into the s8
  epilogue, each level's link handed to that level's predictor group) equal
  the unfused path bit for bit in fp32 and bf16, with all 60 links fused;
  and both against JAX's int8 heads within 2^-22 of each output's largest
  magnitude (tests/test_torch_requant.py's bound); each level's predictor
  group keyed by its own first sibling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg as jax_experiment
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.models import layers as jl
from dd3d_tpu.models.dd3d import dd3d_inference as jax_inference, dd3d_losses as jax_dd3d_losses
from dd3d_tpu.models.fcos2d import FCOS2DHead as JaxFCOS2DHead
from dd3d_tpu.models.fcos3d import FCOS3DHead as JaxFCOS3DHead
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models import layers as pl
from dd3d_tpu_torch.models.dd3d import HEAD_KEYS_2D, HEAD_KEYS_3D, dd3d_inference, dd3d_losses
from dd3d_tpu_torch.models.fcos2d import FCOS2DHead
from dd3d_tpu_torch.models.fcos3d import FCOS3DHead
from dd3d_tpu_torch.utils.convert_checkpoint import assign_quant_paths, convert_flax_variables, flax_param_paths

from tests.test_loss_parity import STRIDES as LOSS_STRIDES, _jax_batch, _random_outputs, _synthetic_gt
from tests.test_torch_decode import STRIDES as DECODE_STRIDES, _head_outputs
from tests.test_torch_regnet_bifpn import seeded_variables
from tests.test_torch_requant import (LEVEL_HW, MEAN_DEPTH, STD_DEPTH, STRIDES, WIDTH, _assert_identical,
                                      _counted_links, _fusion_off, _port_features, _randomize, _run)
from tests.torch_port_util import jax_quant_globals_restored, torch_threads

HEAD_KEYS = HEAD_KEYS_2D + HEAD_KEYS_3D
CLASSES = 3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def options_cfg(get=get_experiment_cfg, fpn=64):
    """dd3d_kitti_dla34 at fp32 with the three head options on."""
    cfg = get("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.FE.FPN.OUT_CHANNELS = fpn
    cfg.DD3D.FCOS2D._VERSION = "v1"
    cfg.DD3D.FCOS3D.PER_LEVEL_PREDICTORS = True
    cfg.DD3D.FCOS3D.CLASS_AGNOSTIC_BOX3D = True
    return cfg


def seeded_pair(cfg_j, cfg_p, seed=3):
    """(JAX model, its seeded variables, the port's model with the same
    weights) of one configuration."""
    jm = build_jax_model(cfg_j)
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    variables = seeded_variables(shapes, seed)
    pm = build_model(cfg_p)
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    return jm, variables, pm


def forward_both(cfg_j, cfg_p, seed=3):
    """Both models' head outputs on the same two 128x128 uint8 images."""
    jm, variables, pm = seeded_pair(cfg_j, cfg_p, seed)
    images = (np.random.RandomState(seed).rand(2, 128, 128, 3) * 255).astype(np.uint8)
    out_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        out_p = pm(torch.from_numpy(images))
    return out_j, out_p, pm


def assert_heads_match(out_j, out_p, keys=HEAD_KEYS, levels=5):
    for key in keys:
        assert len(out_p[key]) == len(out_j[key]) == levels, key
        for lvl, (p, j) in enumerate(zip(out_p[key], out_j[key])):
            assert p.shape == j.shape, (key, lvl)
            np.testing.assert_allclose(p.numpy(), np.asarray(j, np.float32), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{key} level {lvl}")


@pytest.fixture(scope="module")
def options_forward():
    return forward_both(options_cfg(jax_experiment), options_cfg())


@pytest.mark.parametrize("key", HEAD_KEYS)
def test_options_forward_matches_jax(options_forward, key):
    out_j, out_p, _ = options_forward
    assert_heads_match(out_j, out_p, (key,))
    if key in HEAD_KEYS_3D:  # one box a location
        assert out_p[key][0].shape[-1] == {"quat": 4, "proj_ctr": 2, "size": 3}.get(key, 1)


def test_options_parameters_and_quant_paths(options_forward):
    pm = options_forward[2]
    paths = flax_param_paths(pm)
    assert paths["fcos2d_head.cls_tower.0.bias"] == ("fcos2d_head", "cls_tower_conv0", "bias")
    assert paths["fcos2d_head.box2d_tower.3.bias"] == ("fcos2d_head", "box2d_tower_conv3", "bias")
    assert paths["fcos3d_head.box3d_quat.4.weight"] == ("fcos3d_head", "box3d_quat4", "kernel")
    assert pm.fcos3d_head.box3d_tower[0].bias is None  # the 3D tower has no bias in either version
    assert [m.quant_path for m in pm.fcos3d_head.box3d_ctr] == [f"fcos3d_head/box3d_ctr{l}" for l in range(5)]


def _class_agnostic_outputs(seed, b, c):
    """Random head outputs with C-class 2D maps and one-box 3D maps."""
    out, intrinsics = _head_outputs(seed, b, c)
    one, _ = _head_outputs(seed + 1, b, 1)
    out.update({k: one[k] for k in HEAD_KEYS_3D})
    return out, intrinsics


@pytest.mark.parametrize("per_level", [False, True])
def test_class_agnostic_decode_matches_jax(per_level):
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.DD3D.FCOS3D.CLASS_AGNOSTIC_BOX3D = True
    cfg.DD3D.FCOS3D.PER_LEVEL_PREDICTORS = per_level  # no effect on the decode
    out, intrinsics = _class_agnostic_outputs(5, 2, cfg.DD3D.NUM_CLASSES)
    det_j = jax.jit(lambda o, k: jax_inference(cfg, o, k, strides=DECODE_STRIDES))(
        jax.tree_util.tree_map(jnp.asarray, out), jnp.asarray(intrinsics))
    det_j = {k: np.asarray(v) for k, v in det_j.items()}
    det_p = dd3d_inference(cfg, {k: [torch.from_numpy(x) for x in v] for k, v in out.items()},
                           torch.from_numpy(intrinsics), DECODE_STRIDES)
    det_p = {k: v.numpy() for k, v in det_p.items()}
    assert set(det_p) == set(det_j)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert valid.sum() > 20 and len(np.unique(det_j["classes"][valid])) > 1
    for key in ("classes", "fpn_levels"):
        np.testing.assert_array_equal(det_p[key][valid], det_j[key][valid], err_msg=key)
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], rtol=1e-5, atol=1e-5, err_msg=key)


def test_class_agnostic_losses_match_jax():
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.DD3D.FCOS3D.CLASS_AGNOSTIC_BOX3D = True
    rng = np.random.RandomState(11)
    gt_list, intrinsics = _synthetic_gt(rng, cfg.DD3D.NUM_CLASSES, with_empty_image=True)
    _, out_c = _random_outputs(rng, len(gt_list), cfg.DD3D.NUM_CLASSES, LOSS_STRIDES)
    _, out_1 = _random_outputs(rng, len(gt_list), 1, LOSS_STRIDES)
    out_j = {k: (out_1 if k in HEAD_KEYS_3D else out_c)[k] for k in HEAD_KEYS}
    assert out_j["quat"][0].shape[-1] == 4 and out_j["logits"][0].shape[-1] == cfg.DD3D.NUM_CLASSES
    batch_j = _jax_batch(gt_list, intrinsics)

    def total_j(outs):
        losses = jax_dd3d_losses(cfg, outs, batch_j, strides=LOSS_STRIDES)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(total_j, has_aux=True))(out_j)
    batch_p = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    out_p = {k: [torch.from_numpy(np.array(x)).requires_grad_(True) for x in v] for k, v in out_j.items()}
    losses_p = dd3d_losses(cfg, out_p, batch_p, LOSS_STRIDES)
    sum(losses_p.values()).backward()
    assert set(losses_p) == set(losses_j)
    for key, want in losses_j.items():
        got = float(losses_p[key].detach())
        assert np.isfinite(got) and got > 0, key
        np.testing.assert_allclose(got, float(want), rtol=1e-5, err_msg=key)
    for key in HEAD_KEYS_3D:
        top = max(float(np.abs(np.asarray(g)).max()) for g in grads_j[key])
        assert top > 0, key
        for lvl, (p, g) in enumerate(zip(out_p[key], grads_j[key])):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0, atol=1e-5 * top,
                                       err_msg=f"{key} level {lvl}")


# --- static int8 with the options --------------------------------------------------

class JaxOptionHeads(jl.nn.Module):
    """The JAX package's two heads with every option on, under the DD3D
    model's scope names."""

    @jl.nn.compact
    def __call__(self, features):
        out2d = JaxFCOS2DHead(CLASSES, STRIDES, norm="FrozenBN", version="v1", dtype=jnp.float32,
                              name="fcos2d_head")(features)
        out3d = JaxFCOS3DHead(CLASSES, STRIDES, MEAN_DEPTH, STD_DEPTH, per_level_predictors=True,
                              class_agnostic=True, dtype=jnp.float32, name="fcos3d_head")(features)
        return out2d, out3d


class OptionHeads(torch.nn.Module):
    """The port's heads with every option on, under the same names."""

    def __init__(self):
        super().__init__()
        self.fcos2d_head = FCOS2DHead(CLASSES, WIDTH, STRIDES, norm="FrozenBN", version="v1")
        self.fcos3d_head = FCOS3DHead(CLASSES, WIDTH, STRIDES, MEAN_DEPTH, STD_DEPTH, per_level_predictors=True,
                                      class_agnostic=True)

    def forward(self, features):
        out = dict(zip(HEAD_KEYS_2D, self.fcos2d_head(features)))
        out.update(zip(HEAD_KEYS_3D, self.fcos3d_head(features)))
        return out


@pytest.fixture(scope="module")
def option_heads():
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, WIDTH).astype(np.float32) for h, w in LEVEL_HW]
    jm = JaxOptionHeads()
    variables = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]), rng)
    pm = OptionHeads().eval()
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    assign_quant_paths(pm)
    assert float(pm.fcos2d_head.cls_tower[3].bias.detach().abs().max()) > 0.1
    spec = pl.QuantSpec(enabled=True, min_ch=0, unfolded=True, capture=[])
    with torch.no_grad(), pl.quant_scope(spec):
        pm(_port_features(feats, torch.float32))
    scales = {}
    for path, tag, amax in spec.capture:
        scales.setdefault(path, {})[tag] = max(float(amax), scales.get(path, {}).get(tag, 0.0))
    return feats, jm, variables, pm, scales


def test_option_heads_key_each_level_group_by_its_first_sibling(option_heads):
    scales = option_heads[4]
    for lvl, (h, w) in enumerate(LEVEL_HW):
        assert set(scales[f"fcos3d_head/box3d_quat{lvl}"]) == {f"{h}x{w}x{WIDTH}"}
        assert f"fcos3d_head/box3d_conf{lvl}" not in scales  # the group's other siblings never key a scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_option_heads_fused_equal_unfused(option_heads, dtype):
    feats, _, _, pm, scales = option_heads
    with _counted_links() as links:
        fused, spec = _run(pm, feats, dtype, scales=scales)
    with _fusion_off(), _counted_links() as none:
        unfused, spec_u = _run(pm, feats, dtype, scales=scales)
    assert len(links) == 3 * 4 * len(STRIDES) and none == []
    assert spec.misses == spec_u.misses == []
    _assert_identical(fused, unfused)


def test_option_heads_match_jax_int8_heads(option_heads):
    feats, jm, variables, pm, scales = option_heads
    with jax_quant_globals_restored():
        jl.QUANT_INT8, jl.QUANT_MIN_CH, jl.QUANT_UNFOLDED, jl.QUANT_SCALES = True, 0, True, scales
        jl.QUANT_OBSERVED_TAGS, jl.QUANT_SCALE_MISSES = {}, []
        out2d, out3d = jm.apply(variables, [jnp.asarray(f) for f in feats])
        assert jl.QUANT_SCALE_MISSES == []
    jax_out = dict(zip(HEAD_KEYS, list(out2d[:3]) + list(out3d)))
    port, _ = _run(pm, feats, torch.float32, scales=scales)
    for key, levels in jax_out.items():
        for lvl, (j, p) in enumerate(zip(levels, port[key])):
            j = np.asarray(j)
            ulp = 2.0 ** -22 * float(np.abs(j).max())
            np.testing.assert_allclose(p.permute(0, 2, 3, 1).numpy(), j, rtol=0, atol=ulp,
                                       err_msg=f"{key} level {lvl}")
