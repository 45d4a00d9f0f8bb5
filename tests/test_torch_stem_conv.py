"""DLA's stem convs on the stem kernel's path (ops/stem_conv.py), on the
CPU: the plain version against the unfused path the card runs, bit for bit;
the rule that sends a conv to the kernel, case by case; which convs of each
backbone it takes; and the path from DD3D.forward through the FPN and the
trunk, with the plain version standing in for the kernel. The kernel
itself runs on the card only (tests/test_torch_cuda.py)."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model, layers
from dd3d_tpu_torch.models.dd3d import DD3D
from dd3d_tpu_torch.models.dla import DLA, DLA_VARIANTS
from dd3d_tpu_torch.models.layers import ConvNorm, QuantSpec, quant_scope
from dd3d_tpu_torch.ops import stem_conv as stem
from dd3d_tpu_torch.ops.stem_conv import STEM_SHAPES, NormalizedFrames, stem_conv_engages, stem_conv_plain

STEM_CONVS = {"base_layer": (7, 1, 3, 16), "level0": (3, 1, 16, 16), "level1": (3, 2, 16, 32)}


class CardFrames(NormalizedFrames):
    """NormalizedFrames that report the card as their device: the rule reads
    nothing else of them."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def card_tensor(c, h=64, w=96, dtype=torch.bfloat16):
    """A stand-in for a CUDA activation: what the rule reads of one."""
    return SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype, shape=torch.Size((2, c, h, w)))


def card_frames(dtype=torch.bfloat16):
    frames = torch.zeros(2, 64, 96, 3, dtype=torch.uint8)
    return CardFrames(frames, torch.zeros(1, 3, 1, 1), torch.ones(1, 3, 1, 1), dtype)


def exact_stem_conv(name, seed):
    """(x, weight, bias, stride) of one stem conv whose f32 sums are exact
    in any order, through a ConvNorm's own folding: weights and inputs are
    multiples of 2^-6 (frames normalized by mean 128, std 64; the norm's
    scale sqrt(var + eps), so its `mul` is exactly 1), so each product is a
    multiple of 2^-12 and every partial sum below 2^9 holds in f32's 24 bits.
    The bias is arbitrary, so both bf16 roundings of the unfused path bite."""
    k, stride, c, o = STEM_CONVS[name]
    gen = torch.Generator().manual_seed(seed)
    conv = ConvNorm(c, o, k, stride, norm="FrozenBN", relu=True)
    with torch.no_grad():
        conv.weight.copy_(torch.randint(-64, 65, conv.weight.shape, generator=gen) / 64.0)
        conv.norm.running_var.copy_(torch.rand(o, generator=gen) + 0.5)
        conv.norm.weight.copy_(torch.sqrt(conv.norm.running_var + conv.norm.eps))
        conv.norm.running_mean.copy_(torch.randn(o, generator=gen))
        conv.norm.bias.copy_(torch.randn(o, generator=gen))
    weight, bias = conv._folded(*conv.eval().norm.folded())
    assert torch.equal(weight, conv.weight)  # mul is exactly 1
    if c == 3:
        frames = torch.randint(0, 256, (2, 21, 37, 3), generator=gen, dtype=torch.uint8)
        model = SimpleNamespace(pixel_mean=torch.full((1, 3, 1, 1), 128.0), pixel_std=torch.full((1, 3, 1, 1), 64.0),
                                dtype=torch.bfloat16)
        x = NormalizedFrames(frames, model.pixel_mean, model.pixel_std, torch.bfloat16)
        assert torch.equal(x.normalized(), DD3D.preprocess_image(model, frames))
    else:
        x = (torch.randint(-256, 257, (2, 21, 37, c), generator=gen) / 64.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    return x, weight.to(torch.bfloat16), bias.to(torch.bfloat16), stride


@pytest.mark.parametrize("name", list(STEM_CONVS))
def test_plain_is_the_unfused_card_path_bit_for_bit(name):
    """stem_conv_plain equals, bit for bit, what ConvNorm's bf16 path runs on
    the card: preprocess_image for the frames, then F.conv2d, which PyTorch's
    cuDNN dispatch runs as the bf16 conv (f32 sums rounded once) followed by
    a separate bf16 add_ of the bias, then the ReLU. The sums are exact here,
    so the CPU's bf16 conv without a bias gives cuDNN's bits. (The CPU's own
    conv with a bias adds it before its one rounding: other bits, which the
    last assertion shows the test can tell apart.)"""
    x, weight, bias, stride = exact_stem_conv(name, seed=len(name))
    xn = x.normalized() if isinstance(x, NormalizedFrames) else x
    k = weight.shape[-1]
    conv = F.conv2d(xn, weight, None, stride, (k - 1) // 2)
    exact = F.conv2d(xn.double(), weight.double(), None, stride, (k - 1) // 2)
    assert torch.equal(F.conv2d(xn.float(), weight.float(), None, stride, (k - 1) // 2).double(), exact)
    want = F.relu(conv.add_(bias[:, None, None]))
    got = stem_conv_plain(x, weight, bias, stride)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert not torch.equal(got, F.relu(F.conv2d(xn, weight, bias, stride, (k - 1) // 2)))


def test_plain_version_on_the_cpu_is_what_stem_conv_runs():
    x, weight, bias, stride = exact_stem_conv("level1", seed=3)
    assert torch.equal(stem.stem_conv(x, weight, bias, stride), stem_conv_plain(x, weight, bias, stride))


ENGAGES = dict(device_type="cuda", training=False, grad=False, foldable=True, relu=True, dtype=torch.bfloat16,
               groups=1, quantizes=False, capture=False)
EXCLUDED = {
    "cpu": dict(device_type="cpu"),
    "train mode": dict(training=True),
    "autograd on": dict(grad=True),
    "f32": dict(dtype=torch.float32),
    "f16": dict(dtype=torch.float16),
    "norm not folded": dict(foldable=False),
    "no relu": dict(relu=False),
    "grouped": dict(groups=2),
    "quantized": dict(quantizes=True),
    "calibration capture": dict(capture=True),
}


def rule(shape, **overrides):
    k, stride, c, o = shape
    kw = dict(ENGAGES, kernel_size=k, stride=stride, in_channels=c, out_channels=o, frames=c == 3)
    kw.update(overrides)
    return stem_conv_engages(**kw)


@pytest.mark.parametrize("name", list(STEM_CONVS))
def test_rule_takes_the_three_stem_convs(name):
    assert rule(STEM_CONVS[name])


@pytest.mark.parametrize("case", list(EXCLUDED))
@pytest.mark.parametrize("name", list(STEM_CONVS))
def test_rule_excludes(name, case):
    assert not rule(STEM_CONVS[name], **EXCLUDED[case])


@pytest.mark.parametrize("name", list(STEM_CONVS))
def test_rule_takes_frames_at_the_7x7_conv_only(name):
    shape = STEM_CONVS[name]
    assert not rule(shape, frames=shape[2] != 3)


@pytest.mark.parametrize("shape", [(3, 1, 16, 32), (3, 2, 16, 16), (7, 2, 3, 16), (7, 1, 3, 32), (3, 1, 32, 32),
                                   (1, 1, 16, 16), (3, 1, 3, 16), (3, 2, 3, 32), (3, 2, 32, 64), (5, 1, 16, 16)])
def test_rule_takes_no_other_shape(shape):
    assert shape not in STEM_SHAPES
    assert not rule(shape) and not rule(shape, frames=True)


def takers(model, frames_dtype=torch.bfloat16):
    """{module name} of the ConvNorms that take the kernel on a card input
    of their own width (frames where they read 3 channels)."""
    out = set()
    for name, m in model.named_modules():
        if isinstance(m, ConvNorm):
            c = m.weight.shape[1] * m.groups
            x = card_frames(frames_dtype) if c == 3 else card_tensor(c, dtype=frames_dtype)
            if m.takes_stem_kernel(x):
                out.add(name)
    return out


def dla_trunk(variant):
    levels, channels, block, residual_root = DLA_VARIANTS[variant]
    return DLA(levels, channels, block, residual_root, norm="FrozenBN")


@pytest.mark.parametrize("variant", list(DLA_VARIANTS))
def test_every_dla_variant_sends_its_stem_and_nothing_else(variant):
    trunk = dla_trunk(variant).eval()
    assert trunk.reads_frames
    with torch.no_grad():
        assert takers(trunk) == {"base_layer", "level0.0", "level1.0"}
        assert not takers(trunk, torch.float32)
        assert not takers(trunk.train())
    assert not takers(trunk.eval())  # autograd on


@pytest.mark.parametrize("min_ch,want", [(3, set()), (16, {"base_layer"}), (32, {"base_layer", "level0.0", "level1.0"}),
                                         (256, {"base_layer", "level0.0", "level1.0"})])
def test_static_int8_leaves_the_kernel_the_stem_convs_it_does_not_quantize(min_ch, want):
    trunk = dla_trunk("DLA-34").eval()
    with torch.no_grad(), quant_scope(QuantSpec(enabled=True, min_ch=min_ch)):
        assert takers(trunk) == want
    with torch.no_grad(), quant_scope(QuantSpec(enabled=True, min_ch=min_ch, capture=[])):
        assert not takers(trunk)
    with torch.no_grad(), quant_scope(QuantSpec(enabled=False, min_ch=min_ch, unfolded=True)):
        assert takers(trunk) == {"base_layer", "level0.0", "level1.0"}


@pytest.mark.parametrize("experiment", ["dd3d_kitti_v99", "dd3d_kitti_regnety_006_bifpn", "dd3d_nusc_v99"])
def test_non_dla_backbones_keep_todays_path(experiment):
    cfg = get_experiment_cfg(experiment)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(cfg).eval()
    base = getattr(model, "base", model)
    assert not getattr(base.backbone, "reads_frames", False)
    with torch.no_grad():
        assert not takers(model)
        x = backbone_input(base, torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    assert isinstance(x, torch.Tensor) and torch.equal(x, base.preprocess_image(torch.zeros(1, 64, 64, 3,
                                                                                             dtype=torch.uint8)))


class _Stop(Exception):
    pass


def backbone_input(model, frames):
    """What DD3D.forward hands its backbone for `frames`: caught by a
    forward pre-hook, which then stops the forward."""
    seen = []

    def hook(module, args):
        seen.append(args[0])
        raise _Stop

    handle = model.backbone.register_forward_pre_hook(hook)
    try:
        model(frames)
    except _Stop:
        pass
    finally:
        handle.remove()
    return seen[0]


def small_dla34(dtype="bfloat16"):
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.FE.FPN.OUT_CHANNELS = 32
    cfg.DD3D.FCOS2D.NUM_CLS_CONVS = cfg.DD3D.FCOS2D.NUM_BOX_CONVS = cfg.DD3D.FCOS3D.NUM_CONVS = 1
    from dd3d_tpu_torch.training.synthetic import seed_norm_statistics

    return seed_norm_statistics(build_model(cfg, generator=torch.Generator().manual_seed(0)),
                                torch.Generator().manual_seed(1)).eval()


def test_the_cpu_keeps_preprocess_image(monkeypatch):
    """On the CPU the trunk gets the uint8 frames, and `base_layer`
    normalizes them as preprocess_image does, without the stem kernel: the
    features are those of preprocess_image's tensor, bit for bit. Float
    frames reach the trunk as preprocess_image's tensor."""
    monkeypatch.setattr(layers, "stem_conv", None)  # a call would raise
    model = small_dla34()
    frames = torch.randint(0, 256, (1, 64, 128, 3), dtype=torch.uint8)
    with torch.inference_mode():
        x = backbone_input(model, frames)
        assert isinstance(x, NormalizedFrames) and torch.equal(x.normalized(), model.preprocess_image(frames))
        got, want = model.backbone(x), model.backbone(model.preprocess_image(frames))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
        y = backbone_input(model, frames.float())
        assert isinstance(y, torch.Tensor) and torch.equal(y, model.preprocess_image(frames.float()))


def test_frames_reach_the_stem_through_the_fpn(monkeypatch):
    """With the rule told the CPU is the card, DD3D.forward hands the trunk
    the frames, the three stem convs run `stem_conv` (the plain version on
    the CPU) and nothing else sees the frames; the heads agree with the
    unfused forward's to bf16 rounding (the CPU's unfused conv adds the bias
    before its one rounding), and under static int8 the scale lookups, and
    so their misses, are the unfused path's."""
    real_rule = layers.stem_conv_engages
    monkeypatch.setattr(layers, "stem_conv_engages", lambda **kw: real_rule(**dict(kw, device_type="cuda")))
    calls = []

    def counting(x, weight, bias, stride):
        calls.append(type(x).__name__)
        return stem.stem_conv(x, weight, bias, stride)

    monkeypatch.setattr(layers, "stem_conv", counting)
    model = small_dla34()
    frames = torch.randint(0, 256, (1, 64, 128, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        assert isinstance(backbone_input(model, frames), NormalizedFrames)
        fused = model(frames)
        assert calls == ["NormalizedFrames", "Tensor", "Tensor"]
        spec = QuantSpec(enabled=True, min_ch=32, scales={"no/such/conv": {}})
        with quant_scope(spec):
            model(frames)
        misses = list(spec.misses)
    monkeypatch.setattr(layers, "stem_conv_engages", real_rule)
    with torch.inference_mode():
        unfused = model(frames)
        spec = QuantSpec(enabled=True, min_ch=32, scales={"no/such/conv": {}})
        with quant_scope(spec):
            model(frames)
    assert misses == spec.misses and len(misses) > 3
    assert fused.keys() == unfused.keys()
    for key in fused:
        for a, b in zip(fused[key], unfused[key]):
            assert float((a.float() - b.float()).abs().max()) <= 0.05 * float(b.float().abs().max()), key


@pytest.mark.parametrize("frames_at", ["cpu", "train", "f32"])
def test_frames_at_a_conv_without_the_kernel_are_normalized(frames_at):
    """Frames at a conv that does not take the kernel in this call give the
    conv of preprocess_image's tensor, bit for bit."""
    conv = ConvNorm(3, 16, 7, 1, norm="FrozenBN", relu=True).eval()
    frames = torch.randint(0, 256, (1, 8, 8, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(4))
    dtype = torch.float32 if frames_at == "f32" else torch.bfloat16
    conv.to(dtype).train(frames_at == "train")
    x = (CardFrames if frames_at != "cpu" else NormalizedFrames)(frames, torch.full((1, 3, 1, 1), 100.0),
                                                                 torch.full((1, 3, 1, 1), 60.0), dtype)
    with torch.no_grad():
        assert not conv.takes_stem_kernel(x)
        assert torch.equal(conv(NormalizedFrames(x.frames, x.mean, x.std, dtype)), conv(x.normalized()))


def test_stem_conv_rejects_what_it_does_not_take():
    x, weight, bias, stride = exact_stem_conv("level0", seed=1)
    with pytest.raises(ValueError, match="stem conv takes"):
        stem.stem_conv(x, weight, bias, 2)
    with pytest.raises(TypeError, match="bf16"):
        stem.stem_conv(x.float(), weight, bias, stride)
    frames, w7, b7, _ = exact_stem_conv("base_layer", seed=1)
    with pytest.raises(ValueError, match="stem conv takes"):
        stem.stem_conv(frames.normalized(), w7, b7, 1)
