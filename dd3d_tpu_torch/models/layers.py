"""Building-block layers: conv+norm+act, frozen BN, learnable Scale/Offset.

Counterpart of dd3d_tpu/models/layers.py. `model.train()` and
`model.eval()` select the mode, in place of flax's `train=` flag:
- Modules take NCHW tensors (channels_last in memory when the caller feeds
  NHWC images, see models/dd3d.py) and compute in the dtype of the activation
  they are given; parameters stay fp32.
- Parameter and buffer names are the reference checkpoints' (detectron2's
  Conv2d with a `.norm` child; BatchNorm2d's weight / bias / running_mean /
  running_var / num_batches_tracked), as in tests/torch_ref_dd3d.py, so a
  reference state dict loads with `load_state_dict(strict=True)`.
- A norm that is foldable is folded into the preceding conv: the kernel is
  scaled by the norm's per-channel `mul` in fp32 and only then cast to the
  compute dtype (dd3d_tpu/models/layers.py:307-309). Folding after the cast
  gives other bf16 weights. FrozenBN folds in both modes; live BN folds at
  eval only (:404-416). In train mode live BN normalizes with the batch
  statistics of the conv output and updates its running averages (:90-112).
- Under TPU.PALLAS_STEM_DW the DLA stem's stride-1 convs run through
  ops/conv_dw.Conv2dS1Same in train mode, so their weight gradient is the
  CUDA kernel (`FoldableConv.route_weight_grad`).
- int8 post-training quantization (TPU.QUANT_INT8, :134-243, :311-353,
  :474-499): a `QuantSpec` holds the settings of ONE call, entered with
  `quant_scope` (a contextvars.ContextVar, never a module global), so two
  inference functions built from one model with different configs never
  see each other's settings. Eligible convs run through
  ops/int8_conv.int8_conv_dequant.
"""
import contextlib
import contextvars
import json
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.ops.conv_dw import Conv2dS1Same, check_kernel_size
from dd3d_tpu_torch.ops.int8_conv import int8_conv_dequant

logger = logging.getLogger(__name__)


@dataclass
class QuantSpec:
    """The int8 settings of one call, and what the call records.

    A conv is eligible when quantization is `enabled`, its module is
    `quantizable` and it has a folded norm, or any conv when `unfolded`. An
    eligible conv quantizes when its input has at least `min_ch` channels;
    the fused predictors under `unfolded` ignore `min_ch`, as the JAX
    package does (dd3d_tpu/models/layers.py:474). `scales` maps the flax
    scope path of a conv to {"HxWxC" input-shape tag: calibrated amax}; a
    (path, tag) that is missing falls back to the dynamic scale and is
    appended to `misses`. With `capture` a list, every eligible call
    appends (path, tag, max|x| as an f32 tensor), whatever `min_ch` is, like
    JAX's `sow`. `plain` runs the kernels' plain versions, on any device."""

    enabled: bool = False
    min_ch: int = 256
    unfolded: bool = False
    scales: Dict[str, Dict[str, float]] = field(default_factory=dict)
    plain: bool = False
    capture: Optional[List[Tuple[str, str, torch.Tensor]]] = None
    misses: List[Tuple[str, str]] = field(default_factory=list)


_QUANT = contextvars.ContextVar("dd3d_tpu_torch_quant", default=QuantSpec())


@contextlib.contextmanager
def quant_scope(spec: QuantSpec):
    """Run the enclosed forward under `spec`."""
    token = _QUANT.set(spec)
    try:
        yield spec
    finally:
        _QUANT.reset(token)


def load_quant_scales(path: str) -> Dict[str, Dict[str, float]]:
    """A calibration JSON {conv_path: {shape_tag: amax}}, the schema of
    dd3d_tpu/models/layers.py::load_quant_scales. Legacy files
    ({conv_path: [amax per call]} + "__tags__") convert; a legacy file
    without tags cannot be keyed safely and is rejected."""
    with open(path) as f:
        raw = json.load(f)
    tags = raw.pop("__tags__", None)
    scales = {}
    for k, v in raw.items():
        if isinstance(v, dict):
            scales[str(k)] = {str(t): float(a) for t, a in v.items()}
            continue
        if tags is None or k not in tags:
            raise ValueError(f"{path}: legacy per-call scales for {k!r} without shape tags cannot be used "
                             "safely; recalibrate with python -m dd3d_tpu_torch.calibrate_int8")
        ent = {}
        for t, a in zip(tags[k], v if isinstance(v, (list, tuple)) else [v]):
            ent[str(t)] = max(float(a), ent.get(str(t), 0.0))
        scales[str(k)] = ent
    return scales


def quant_spec_from_cfg(cfg, plain: bool = False) -> QuantSpec:
    """The spec of TPU.QUANT_INT8 / QUANT_MIN_CH / QUANT_UNFOLDED /
    QUANT_SCALES_PATH (the keys of set_quant_from_cfg, :230-243)."""
    tpu = cfg.get("TPU", {})
    scales_path = tpu.get("QUANT_SCALES_PATH", "") or ""
    return QuantSpec(
        enabled=bool(tpu.get("QUANT_INT8", False)),
        min_ch=int(tpu.get("QUANT_MIN_CH", 256)),
        unfolded=bool(tpu.get("QUANT_UNFOLDED", False)),
        scales=load_quant_scales(scales_path) if scales_path else {},
        plain=plain,
    )


def _observe(spec: QuantSpec, path: Optional[str], x: torch.Tensor) -> Optional[float]:
    """Capture and static-scale lookup of one eligible conv call (:320-338);
    returns the static amax, or None for the dynamic scale."""
    if path is None:
        raise ValueError("a quantizing conv needs its flax scope path (quant_path); build the model with "
                         "build_model, or set it")
    tag = f"{x.shape[2]}x{x.shape[3]}x{x.shape[1]}"  # the JAX tag is of the NHWC shape
    if spec.capture is not None:
        spec.capture.append((path, tag, x.detach().abs().amax().float()))
    if not spec.scales:
        return None
    amax = spec.scales.get(path, {}).get(tag)
    if amax is None:
        spec.misses.append((path, tag))
        logger.warning("static int8 scales: no calibrated scale for %s at shape %s - falling back to a dynamic "
                       "scale (recalibrate for this canvas)", path, tag)
    return amax


class _NormStats(nn.Module):
    """weight / bias / running_mean / running_var / num_batches_tracked, the
    entries of a reference BatchNorm2d checkpoint."""

    def __init__(self, features: int, eps: float = 1e-5, learnable: bool = True):
        super().__init__()
        self.eps = eps
        if learnable:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_buffer("weight", torch.ones(features))
            self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def folded(self):
        raise NotImplementedError

    @property
    def foldable(self) -> bool:
        """Whether `folded()` gives this norm's affine in the current mode."""
        return True

    def affine(self, x):
        return self.folded()

    def forward(self, x):
        # The affine in the ACTIVATION dtype, like d2's FrozenBatchNorm2d.
        mul, add = self.affine(x)
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class FrozenBatchNorm(_NormStats):
    """Frozen statistics and affine (dd3d_tpu FrozenBatchNorm): all four are
    buffers, and `folded()` uses 1/sqrt like the JAX module (:51-55)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps, learnable=False)

    def folded(self):
        """(mul, add) fp32 so that norm(x) == x * mul + add."""
        mul = self.weight / torch.sqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul


class FoldableBatchNorm(_NormStats):
    """Live BatchNorm (flax nn.BatchNorm(momentum=0.9, epsilon=1e-5), JAX
    :64-112). At eval: the running-stat affine, with rsqrt, foldable. In
    train mode: the statistics of the batch in f32 over (N, H, W), the
    biased variance, and the running averages updated as
    ra = 0.9 * ra + 0.1 * stat (biased variance too). JAX forms the variance
    as E[x^2] - E[x]^2 (:96), which cancels in f32 where a level has few
    values a channel (P7 at a small canvas); the port takes the same biased
    variance from one var_mean reduction, which does not cancel and stays
    nearer the f64 result (tests/test_torch_train.py holds both against it)."""

    momentum = 0.9

    @property
    def foldable(self) -> bool:
        return not self.training

    def folded(self):
        if self.training:
            raise RuntimeError("live BatchNorm normalizes with batch statistics in train mode; it does not fold")
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul

    def affine(self, x):
        if not self.training:
            return self.folded()
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul


def make_norm(norm: str, features: int) -> Optional[_NormStats]:
    """BN / FrozenBN / '' (none), like detectron2's `get_norm`."""
    if norm == "BN":
        return FoldableBatchNorm(features)
    if norm == "FrozenBN":
        return FrozenBatchNorm(features)
    if norm in ("", None):
        return None
    raise NotImplementedError(f"Norm {norm!r}")


# Weight inits of the JAX package (flax variance_scaling): kaiming normal over
# fan_out for backbone and towers; uniform over fan_in (kaiming_uniform(a=1),
# which equals caffe2's XavierFill) for predictors and FPN convs.
INIT_NORMAL_FAN_OUT = "normal_fan_out"
INIT_UNIFORM_FAN_IN = "uniform_fan_in"


def _init_weight(weight: torch.Tensor, init: str, generator: Optional[torch.Generator]):
    if init == INIT_NORMAL_FAN_OUT:
        nn.init.kaiming_normal_(weight, mode="fan_out", nonlinearity="relu", generator=generator)
    elif init == INIT_UNIFORM_FAN_IN:
        nn.init.kaiming_uniform_(weight, a=1, mode="fan_in", generator=generator)
    else:
        raise ValueError(init)


class FoldableConv(nn.Module):
    """Conv whose kernel/bias can absorb a following norm's per-channel affine:
    norm(conv(x) + b) == conv_{W*mul}(x) + (b*mul + add). Under an enabled
    QuantSpec it is an int8 conv where the eligibility rule says so;
    `quant_path` is its flax scope path (utils/convert_checkpoint.py)."""

    quantizable = True
    quant_path: Optional[str] = None
    # Train-mode weight gradient through the CUDA kernel (route_weight_grad);
    # `weight_grad_plain` runs its plain version instead, on any device.
    kernel_weight_grad = False
    weight_grad_plain = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 bias: bool = False, init: str = INIT_NORMAL_FAN_OUT):
        super().__init__()
        self.kernel_size, self.stride, self.init = kernel_size, stride, init
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _init_weight(self.weight.data, self.init, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def route_weight_grad(self) -> None:
        """Run this conv through ops/conv_dw.Conv2dS1Same in train mode (the
        plain DLA stem under TPU.PALLAS_STEM_DW). Only a stride-1 conv with
        an odd k <= 9 has the kernel; any other raises here."""
        if self.stride != 1:
            raise ValueError(f"the weight-gradient kernel takes stride-1 convs; this one has stride {self.stride}")
        check_kernel_size(self.kernel_size)
        self.kernel_weight_grad = True

    def forward(self, x, mul=None, add=None):
        weight, bias = self.weight, self.bias
        if mul is not None:
            weight = weight * mul[:, None, None, None]  # fp32, before the cast
            bias = bias * mul + add if bias is not None else add
        pad = (self.kernel_size - 1) // 2
        if self.kernel_weight_grad and self.training:
            # conv, then the bias in the activation dtype, as the s2d stem's
            # conv2d_s1_same path does (dd3d_tpu/models/s2d.py:310-314)
            y = Conv2dS1Same.apply(x, weight.to(x.dtype), self.weight_grad_plain)
            return y if bias is None else y + bias.to(x.dtype)[:, None, None]
        spec = _QUANT.get()
        if spec.enabled and self.quantizable and (mul is not None or spec.unfolded):
            act_amax = _observe(spec, self.quant_path, x)
            if x.shape[1] >= spec.min_ch:
                return int8_conv_dequant(x, weight, bias, self.stride, pad, x.dtype, act_amax, spec.plain)
        return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), self.stride, pad)


class PlainConv(FoldableConv):
    """A conv that never quantizes: the counterpart of flax's plain nn.Conv
    (the FPN's P6/P7, dd3d_tpu/models/fpn.py:110-117), which the JAX
    package's int8 rule never reaches, even under TPU.QUANT_UNFOLDED."""

    quantizable = False


class ConvNorm(FoldableConv):
    """Conv -> norm (folded) -> optional relu, like detectron2's Conv2d with
    `.norm`. bias is on iff there is no norm (dd3d_tpu ConvNorm)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = "BN", relu: bool = False, init: str = INIT_NORMAL_FAN_OUT):
        super().__init__(in_channels, out_channels, kernel_size, stride, bias=norm in ("", None), init=init)
        self.norm = make_norm(norm, out_channels)
        self.relu = relu

    def forward(self, x):
        if self.norm is None:
            y = super().forward(x)
        elif self.norm.foldable:
            y = super().forward(x, *self.norm.folded())
        else:
            y = self.norm(super().forward(x))
        return F.relu(y) if self.relu else y


class PerLevelNorms(nn.ModuleList):
    """One norm per FPN level, chosen by an explicit level index (the
    reference's round-robin `ModuleListDial` without its hidden state)."""

    def __init__(self, num_levels: int, features: int, norm: str):
        if norm in ("", None):
            raise NotImplementedError("per-level norms need a norm (BN or FrozenBN)")
        super().__init__([make_norm(norm, features) for _ in range(num_levels)])

    def forward(self, x, level: int):
        return self[level](x)


class TowerConv(FoldableConv):
    """A head-tower layer: one conv shared by all levels, each level's norm
    folded into its own application of the kernel (never averaged), then relu;
    a live BN in train mode normalizes each level with its own batch
    statistics instead (dd3d_tpu/models/fcos2d.py:140-149).
    Reference names: `<tower>.<i>.weight`, `<tower>.<i>.norm.<level>.*`."""

    def __init__(self, channels: int, num_levels: int, norm: str):
        super().__init__(channels, channels, 3, init=INIT_NORMAL_FAN_OUT)
        self.norm = PerLevelNorms(num_levels, channels, norm)

    def forward(self, x, level: int):
        norm = self.norm[level]
        if norm.foldable:
            return F.relu(super().forward(x, *norm.folded()))
        return F.relu(norm(super().forward(x)))


class PredictorConv(nn.Module):
    """A head's 3x3 predictor conv (weight + optional bias); siblings reading
    the same map run as one conv through `fused_predictor_apply`."""

    quant_path: Optional[str] = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, bias: bool = True):
        super().__init__()
        self.kernel_size, self.out_channels = kernel_size, out_channels
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _init_weight(self.weight.data, INIT_UNIFORM_FAN_IN, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        return fused_predictor_apply(x, [self])[0]


def fused_predictor_apply(x, preds):
    """Run sibling PredictorConvs as ONE conv over output-channel-concatenated
    kernels, then split. Exact: each output channel is computed as by its own
    conv; a bias-free predictor gets a zero bias slice (dd3d_tpu :457-515).
    Under TPU.QUANT_UNFOLDED the group is one int8 conv, keyed by the first
    sibling's scope path, whatever QUANT_MIN_CH is (:474-499)."""
    k = preds[0].kernel_size
    if any(m.kernel_size != k for m in preds):
        raise ValueError("fused predictors need one kernel size")
    weight = preds[0].weight if len(preds) == 1 else torch.cat([m.weight for m in preds], 0)
    bias = None
    if any(m.bias is not None for m in preds):
        bias = torch.cat([m.bias if m.bias is not None else m.weight.new_zeros(m.out_channels)
                          for m in preds])
    spec = _QUANT.get()
    if spec.enabled and spec.unfolded:
        act_amax = _observe(spec, preds[0].quant_path, x)
        y = int8_conv_dequant(x, weight, bias, 1, k // 2, x.dtype, act_amax, spec.plain)
    else:
        y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=k // 2)
    return list(torch.split(y, [m.out_channels for m in preds], dim=1))


class Scale(nn.Module):
    """Learnable scalar multiplier, applied in the activation dtype."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value], dtype=torch.float32))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class Offset(nn.Module):
    """Learnable scalar offset, applied in the activation dtype."""

    def __init__(self, init_value: float = 0.0):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([init_value], dtype=torch.float32))

    def forward(self, x):
        return x + self.bias.to(x.dtype)
