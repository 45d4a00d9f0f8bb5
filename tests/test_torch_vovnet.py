"""The port's VoVNet (dd3d_tpu_torch/models/vovnet.py) and FPN tops
(models/fpn.py) against the JAX package's, on the CPU in fp32:

- the trunk against `VoVNet.apply` at every stage, for V-19-slim-eSE,
  V-19-slim-dw-eSE (the depthwise path and `conv_reduction`) and V-39-eSE
  (stages of two blocks: identity adds, eSE in every block), at 128x192 (the
  stage-3..5 max-pools see even sizes) and 140x204 (odd ones);
- the FPN with the "p6" and "maxpool" tops and FE.FPN.FUSE_TYPE=avg, over
  the VoVNet trunk and the DLA-34 trunk (the two DLA builders of this slice);
- the V-99-eSE preset built but not run: its parameter names and shapes
  equal those of JAX's `init` through `convert_flax_variables` with strict
  checking, and a reference-named state dict loads strictly;
- the reference's slash names (depthwise too) land where the JAX package's
  converter puts them.

Tolerance atol = rtol = 1e-4, as in tests/test_torch_model.py: both sides
are fp32 on the CPU and differ only in summation order. The weights are
flax's own initializers (He by fan-out for the ConvNorms), which keep the
activations of order one through the trunk, with every norm statistic, norm
affine and bias drawn from the seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_cfg
from dd3d_tpu.models import build_feature_extractor as jax_build_feature_extractor
from dd3d_tpu.models.vovnet import VOVNET_SPECS as JAX_SPECS, VoVNet as JaxVoVNet, hsigmoid as jax_hsigmoid
from dd3d_tpu.utils.convert_checkpoint import convert_torch_state_dict
from dd3d_tpu_torch.configs import get_cfg as port_get_cfg
from dd3d_tpu_torch.models import build_feature_extractor, build_model
from dd3d_tpu_torch.models.vovnet import VOVNET_SPECS, VoVNet, hsigmoid
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables, reference_to_port_names

from tests.torch_port_util import TorchKittiVoVNetDD3D, seed_flax_variables, to_torch_nchw, torch_threads, \
    v99_cfg
from tests.torch_ref_dd3d import randomize_state

STAGES = ("stage2", "stage3", "stage4", "stage5")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def test_presets_match_jax():
    assert VOVNET_SPECS == JAX_SPECS


@pytest.mark.parametrize("variant", ["V-19-slim-eSE", "V-19-slim-dw-eSE", "V-39-eSE"])
@pytest.mark.parametrize("hw", [(128, 192), (140, 204)])
def test_trunk_matches_jax(variant, hw):
    jm = JaxVoVNet(variant, out_features=("stem",) + STAGES, norm="FrozenBN", dtype=jnp.float32)
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    variables = seed_flax_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    out_j = jm.apply(variables, jnp.asarray(x))
    pm = VoVNet(variant, out_features=("stem",) + STAGES, norm="FrozenBN").eval()
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    with torch.no_grad():
        out_p = pm(to_torch_nchw(x).contiguous(memory_format=torch.channels_last))
    assert set(out_p) == set(out_j)
    for f in out_j:
        assert out_p[f].is_contiguous(memory_format=torch.channels_last), f
        np.testing.assert_allclose(out_p[f].permute(0, 2, 3, 1).numpy(), np.asarray(out_j[f]), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{variant} {hw} {f}")
    depthwise = JAX_SPECS[variant]["dw"]
    assert (pm.OSA3_1.conv_reduction is not None) == depthwise and pm.OSA2_1.conv_reduction is None
    assert hasattr(pm.OSA5_1, "ese") and all(hasattr(getattr(pm, n), "ese") for b in pm.stages for n in b)


def test_hsigmoid_is_jax_bit_for_bit_in_bf16():
    """relu6(x + 3) / 6 rounded at each step, not hardsigmoid's one rounding."""
    x = np.linspace(-8, 8, 20001, dtype=np.float32)
    want = np.asarray(jax_hsigmoid(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = hsigmoid(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)


FPN_CASES = [
    ("build_fcos_vovnet_fpn_backbone_p6", "sum"),
    ("build_vovnet_fpn_backbone", "sum"),
    ("build_fcos_vovnet_fpn_backbone_p6", "avg"),
    ("build_fcos_dla_fpn_backbone_p6", "sum"),
    ("build_dla_fpn_backbone", "avg"),
]


def fpn_cfgs(builder, fuse):
    """(JAX cfg, port cfg): the builder over V-19-slim-eSE or DLA-34, FPN 64,
    FrozenBN."""
    cfgs = []
    for get in (get_cfg, port_get_cfg):
        cfg = get()
        cfg.FE.BUILDER = builder
        cfg.FE.FPN.FUSE_TYPE = fuse
        cfg.FE.FPN.OUT_CHANNELS = 64
        cfg.FE.FPN.NORM = cfg.FE.BACKBONE.NORM = "FrozenBN"
        cfg.TPU.COMPUTE_DTYPE = "float32"
        if "vovnet" in builder:
            cfg.FE.BACKBONE.NAME = "V-19-slim-eSE"
            cfg.FE.BACKBONE.OUT_FEATURES = cfg.FE.FPN.IN_FEATURES = ["stage3", "stage4", "stage5"]
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("builder,fuse", FPN_CASES)
def test_fpn_tops_and_fusion_match_jax(builder, fuse):
    cfg_j, cfg_p = fpn_cfgs(builder, fuse)
    jm = jax_build_feature_extractor(cfg_j)
    x = np.random.RandomState(2).randn(2, 128, 192, 3).astype(np.float32)
    # DLA-34's residual blocks and roots grow the activations at unit norm
    # scales (to ~1e2 at P5); at 0.5 they stay of order one, as VoVNet's do
    variables = seed_flax_variables(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), seed=4,
                                 norm_scale=0.5 if "dla" in builder else 1.0)
    out_j = jm.apply(variables, jnp.asarray(x))
    pm = build_feature_extractor(cfg_p).eval()
    pm.load_state_dict(load_backbone_state(variables, pm), strict=True)
    with torch.no_grad():
        out_p = pm(to_torch_nchw(x))
    assert list(out_p) and set(out_p) == set(out_j) == {"p3", "p4", "p5", "p6"}
    assert pm.out_feature_strides == jm.out_feature_strides and pm.size_divisibility == jm.size_divisibility == 64
    for f in out_j:
        np.testing.assert_allclose(out_p[f].permute(0, 2, 3, 1).numpy(), np.asarray(out_j[f]), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{builder} {fuse} {f}")
    top_params = [n for n, _ in pm.top_block.named_parameters()]
    assert top_params == ([] if builder in ("build_vovnet_fpn_backbone", "build_dla_fpn_backbone")
                          else ["p6.weight", "p6.bias"])


class _Wrapped(torch.nn.Module):
    """A bare backbone under the name `backbone`, as in a DD3D model."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def load_backbone_state(variables, backbone):
    """The port state dict of a bare backbone from its JAX variables, through
    the converter of whole models (it names the FPN's laterals by the trunk
    features it finds under `backbone`)."""
    state = convert_flax_variables({k: {"backbone": v} for k, v in variables.items()}, _Wrapped(backbone))
    return {k[len("backbone."):]: v for k, v in state.items()}


def test_v99_preset_parameters_match_jax_init():
    """dd3d_kitti_v99 at full width (V-99-eSE, FPN 256, P3-P6): every JAX
    leaf of an abstract `init` has a place in the port with its shape, and
    every tensor of the port one in JAX (strict conversion)."""
    from dd3d_tpu.configs import get_experiment_cfg
    from dd3d_tpu.models import build_model as build_jax_model

    cfg = get_experiment_cfg("dd3d_kitti_v99")
    shapes = jax.eval_shape(lambda r, x: build_jax_model(cfg).init(r, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 256, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    pm = build_model(v99_cfg("V-99-eSE"))
    state = convert_flax_variables(zeros, pm, strict=True)
    assert set(state) == set(pm.state_dict())
    counts = {"OSA": 0, "ese": 0}
    for name in pm.state_dict():
        counts["OSA"] += name.endswith("concat.weight")
        counts["ese"] += name.endswith("ese.fc.weight")
    assert counts == {"OSA": 16, "ese": 16}  # 1 + 3 + 9 + 3 blocks, eSE in every one
    assert len(pm.fcos3d_head.scales_depth) == len(pm.fcos3d_head.offsets_depth) == 4
    assert [len(t.norm) for t in pm.fcos2d_head.cls_tower] == [4] * 4


def test_reference_named_v99_state_dict_loads_strictly():
    """A state dict with the reference's V-99 names (`stem.stem_1/conv.weight`,
    `stage4.OSA4_9.layers.4.OSA4_9_4/norm.running_var`, `top_block.p6`, the
    fifth depth Scale/Offset) loads strictly, each value where the JAX
    package's converter puts it."""
    tm = TorchKittiVoVNetDD3D(VOVNET_SPECS["V-99-eSE"])
    randomize_state(tm, seed=5)
    sd = tm.state_dict()
    for key in ("backbone.bottom_up.stem.stem_1/conv.weight",
                "backbone.bottom_up.stage2.OSA2_1.layers.0.OSA2_1_0/conv.weight",
                "backbone.bottom_up.stage2.OSA2_1.concat.OSA2_1_concat/norm.running_var",
                "backbone.bottom_up.stage2.OSA2_1.ese.fc.bias",
                "backbone.bottom_up.stage4.OSA4_9.layers.4.OSA4_9_4/norm.running_var",
                "backbone.top_block.p6.weight", "fcos3d_head.scales_depth.4.scale"):
        assert key in sd, key
    pm = build_model(v99_cfg("V-99-eSE"))
    pm.load_state_dict(reference_to_port_names(sd, pm), strict=True)
    bu = pm.backbone.bottom_up
    assert torch.equal(bu.stem1.weight, sd["backbone.bottom_up.stem.stem_1/conv.weight"])
    assert torch.equal(bu.OSA4_9.layer4.norm.running_var,
                       sd["backbone.bottom_up.stage4.OSA4_9.layers.4.OSA4_9_4/norm.running_var"])
    assert torch.equal(bu.OSA3_3.ese.fc.bias, sd["backbone.bottom_up.stage3.OSA3_3.ese.fc.bias"])
    assert torch.equal(pm.backbone.top_block.p6.weight, sd["backbone.top_block.p6.weight"])
    stray = dict(sd, **{"backbone.bottom_up.stage2.OSA2_1.stray.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="stray"):
        pm.load_state_dict(reference_to_port_names(stray, pm), strict=True)


def test_depthwise_reference_names_match_the_jax_converter():
    """V-19-slim-dw-eSE's reference names (`OSA2_1_0/dw_conv3x3`,
    `/pw_conv1x1`, `/pw_norm`, `conv_reduction.OSA3_1_reduction/conv`) land
    on the same values in the port as through the JAX package's converter
    and back through the port's."""
    cfg_j, cfg_p = fpn_cfgs("build_fcos_vovnet_fpn_backbone_p6", "sum")
    cfg_j.FE.BACKBONE.NAME = cfg_p.FE.BACKBONE.NAME = "V-19-slim-dw-eSE"
    jm = jax_build_feature_extractor(cfg_j)
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x), jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    zeros = {k: {"backbone": v} for k, v in jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                                    shapes).items()}
    pm = _Wrapped(build_feature_extractor(cfg_p))
    rng = np.random.RandomState(6)
    ref = {}
    for name, t in pm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        ref[reference_name(name)] = rng.randn(*t.shape).astype(np.float32)
    assert "backbone.bottom_up.stage2.OSA2_1.layers.1.OSA2_1_1/dw_conv3x3.weight" in ref
    assert "backbone.bottom_up.stage3.OSA3_1.conv_reduction.OSA3_1_reduction/norm.running_mean" in ref
    params, batch_stats = convert_torch_state_dict(ref, zeros, strict=True)
    via_jax = convert_flax_variables({"params": params, "batch_stats": batch_stats}, pm)
    direct = reference_to_port_names({k: torch.from_numpy(v) for k, v in ref.items()}, pm)
    assert set(direct) == set(via_jax) - {k for k in via_jax if k.endswith("num_batches_tracked")}
    for k, v in direct.items():
        assert torch.equal(v, via_jax[k]), k


def reference_name(port_name: str) -> str:
    """The reference checkpoint's name of a port VoVNet tensor (vovnet.py's
    OrderedDict names), for the test above."""
    import re

    parts = port_name.split(".")
    if "bottom_up" not in parts:
        return port_name
    i = parts.index("bottom_up") + 1
    head, mod, rest = parts[:i], parts[i], parts[i + 1:]
    m = re.match(r"stem(\d)$", mod)
    if m:
        kind = "norm" if rest[0] == "norm" else "conv"
        return ".".join(head + ["stem", f"stem_{m.group(1)}/{kind}", rest[-1]])
    stage = re.match(r"OSA(\d)_\d+$", mod).group(1)
    blk = [f"stage{stage}", mod]
    sub, leaf = rest[0], rest[-1]
    norm = "norm" in rest
    if sub.startswith("layer"):
        i = sub[len("layer"):]
        if rest[1] == "dw":
            name = "dw_conv3x3"
        elif rest[1] == "pw":
            name = "pw_norm" if norm else "pw_conv1x1"
        else:
            name = "norm" if norm else "conv"
        return ".".join(head + blk + ["layers", i, f"{mod}_{i}/{name}", leaf])
    if sub in ("concat", "conv_reduction"):
        post = "concat" if sub == "concat" else "reduction"
        return ".".join(head + blk + [sub, f"{mod}_{post}/{'norm' if norm else 'conv'}", leaf])
    return ".".join(head + blk + rest)  # ese.fc
