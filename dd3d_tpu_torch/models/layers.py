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
  statistics of the conv output and updates its running averages (:90-112);
  with a process group these are the global batch's statistics (SyncBN,
  `sync_batch_moments`).
- Under TPU.PALLAS_STEM_DW the DLA stem's stride-1 convs run through
  ops/conv_dw.Conv2dS1Same in train mode, so their weight gradient is the
  CUDA kernel (`FoldableConv.route_weight_grad`).
- int8 post-training quantization (TPU.QUANT_INT8, :134-243, :311-353,
  :474-499): a `QuantSpec` holds the settings of ONE call, entered with
  `quant_scope` (a contextvars.ContextVar, never a module global), so two
  inference functions built from one model with different configs never
  see each other's settings. Eligible convs run through
  ops/int8_conv.int8_conv_dequant, grouped ones (RegNet's Y-block `b`,
  BiFPN's depthwise `dw`) through its grouped kernel.
- Along a head tower (`run_tower`), a conv that quantizes and whose
  consumer (the next tower conv, or the predictors after the last) quantizes
  at a known static scale writes the consumer's int8 codes from its
  epilogue (`TowerConv.link_amax` says when), with the ReLU fused: no bf16
  tensor, ReLU or quantize launch between the two. The result is the
  unfused path's, bit for bit.
- DLA's full-resolution stem convs (`base_layer` 7x7 3 -> 16, `level0` 3x3
  16 -> 16, `level1` 3x3/2 16 -> 32) run through ops/stem_conv's CUDA
  kernel, conv, bias and ReLU in one launch, where
  `ConvNorm.takes_stem_kernel` says so in this call
  (ops/stem_conv.stem_conv_engages: CUDA, eval without autograd, bf16, a
  folded norm and a ReLU, the conv not quantizing and no calibration
  capturing). A ConvNorm handed the uint8 frames themselves
  (ops/stem_conv.NormalizedFrames; DLA's `base_layer`, models/dd3d.py)
  normalizes them in the kernel's load, or, where the rule does not hold,
  as DD3D.preprocess_image does before its own conv.
"""
import contextlib
import contextvars
import json
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.ops.conv_dw import Conv2dS1Same, check_kernel_size
from dd3d_tpu_torch.ops.int8_conv import QuantizedActivation, int8_conv_dequant
from dd3d_tpu_torch.ops.stem_conv import STEM_SHAPES, NormalizedFrames, stem_conv, stem_conv_engages
from dd3d_tpu_torch.utils.profiling import annotate

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
# True while TPU.REMAT recomputes a forward in backward (training/remat.py):
# the recompute leaves the state a forward updates, live BN's running
# averages, as the first forward left it.
RECOMPUTING = contextvars.ContextVar("dd3d_tpu_torch_recomputing", default=False)


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
    ra = 0.9 * ra + 0.1 * stat (biased variance too), once a step: a REMAT
    recompute (RECOMPUTING) normalizes alike and updates nothing. JAX forms
    the variance as E[x^2] - E[x]^2 (:96), which cancels in f32 where a
    level has few values a channel (P7 at a small canvas); the port takes
    the same biased variance from one var_mean reduction, which does not
    cancel and stays nearer the f64 result (tests/test_torch_train.py holds
    both against it)."""

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
        xf = x.float()
        if dist.is_initialized():
            var, mean = sync_batch_moments(xf)
        else:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        if not RECOMPUTING.get():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul


def combine_moments(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(biased variance, mean) per channel of the union of the ranks'
    batches, from `stats` (W, 3, C): each rank's count, mean and biased
    variance. The exact pooled form, var = sum_r (n_r / N) (var_r +
    (mean_r - mean)^2): no E[x^2] - E[x]^2 over the whole batch, which
    cancels in f32 (ROADMAP §3, settled traps). A rank with no values
    (n_r = 0) weighs nothing; with one rank the weights are exactly 1 and
    its own (var, mean) come back unchanged."""
    n, means, variances = stats[:, 0], stats[:, 1], stats[:, 2]
    weight = n / n.sum(dim=0).clamp(min=1.0)
    mean = (weight * means).sum(dim=0)
    var = (weight * (variances + (means - mean) ** 2)).sum(dim=0)
    return var, mean


def sync_batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global SyncBN statistics of an NCHW activation: (biased variance,
    mean) per channel over (N, H, W) of every rank's batch, as JAX's BN
    takes them over the batch sharded along the mesh (dd3d_tpu
    layers.py:90-112). Each rank writes its count, mean and biased variance
    into its own row of a (W, 3, C) zero tensor, and ONE all-reduce (sum),
    whose backward all-reduces the gradient (`AllReduceSum`), hands every
    rank all rows; `combine_moments` pools them. An empty activation
    contributes count 0."""
    world, rank = dist.get_world_size(), dist.get_rank()
    count = x.numel() // x.shape[1]
    if count:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    else:
        var = mean = x.new_zeros(x.shape[1]) + x.sum()  # keeps the graph
    own = torch.stack([torch.full_like(mean, float(count)), mean, var])
    rows = F.pad(own[None], (0, 0, 0, 0, rank, world - 1 - rank))
    sync_batch_moments.calls += 1
    return combine_moments(AllReduceSum.apply(rows))


sync_batch_moments.calls = 0  # all-reduces issued in forward passes (a REMAT recompute's too)


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks, with the gradient summed over the
    ranks in turn: each rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


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
                 bias: bool = False, init: str = INIT_NORMAL_FAN_OUT, groups: int = 1):
        super().__init__()
        self.kernel_size, self.stride, self.init, self.groups = kernel_size, stride, init, groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size))
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

    def quantizes(self, spec: QuantSpec, folded: bool, in_channels: int) -> bool:
        """Whether this conv runs as an int8 conv under `spec`, with a folded
        norm or not, on an input of `in_channels` channels."""
        return spec.enabled and self.quantizable and (folded or spec.unfolded) and in_channels >= spec.min_ch

    def _folded(self, mul, add):
        """(weight, bias) with the norm's `mul`/`add` folded in, in fp32."""
        if mul is None:
            return self.weight, self.bias
        weight = self.weight * mul[:, None, None, None]  # fp32, before the cast
        return weight, self.bias * mul + add if self.bias is not None else add

    def forward(self, x, mul=None, add=None, requant_amax=None):
        """The conv (the norm's `mul`/`add` folded in). With `requant_amax`
        (TowerConv's fused link), the QuantizedActivation of its ReLU at
        that static amax's scale; a QuantizedActivation `x` must take the
        int8 path."""
        pad = (self.kernel_size - 1) // 2
        if self.kernel_weight_grad and self.training:
            # conv, then the bias in the activation dtype, as the s2d stem's
            # conv2d_s1_same path does (dd3d_tpu/models/s2d.py:310-314)
            weight, bias = self._folded(mul, add)
            y = Conv2dS1Same.apply(x, weight.to(x.dtype), self.weight_grad_plain)
            return y if bias is None else y + bias.to(x.dtype)[:, None, None]
        spec = _QUANT.get()
        if spec.enabled and self.quantizable and (mul is not None or spec.unfolded):
            act_amax = _observe(spec, self.quant_path, x)
            if x.shape[1] >= spec.min_ch:  # all input channels, not a group's (JAX :339)
                with annotate("int8.conv"):
                    weight, bias = self._folded(mul, add)
                    return int8_conv_dequant(x, weight, bias, self.stride, pad, x.dtype, act_amax, spec.plain,
                                             self.groups, requant_amax=requant_amax)
        weight, bias = self._folded(mul, add)
        if isinstance(x, QuantizedActivation) or requant_amax is not None:
            raise RuntimeError("a fused int8 link reached a conv that does not quantize")
        return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), self.stride, pad,
                        groups=self.groups)


class PlainConv(FoldableConv):
    """A conv that never quantizes: the counterpart of flax's plain nn.Conv
    (the FPN's P6/P7, dd3d_tpu/models/fpn.py:110-117; VoVNet's eSE `fc` and
    depthwise `dw`, dd3d_tpu/models/vovnet.py:55,68), which the JAX
    package's int8 rule never reaches, even under TPU.QUANT_UNFOLDED."""

    quantizable = False


class ConvNorm(FoldableConv):
    """Conv -> norm (folded) -> optional relu or swish (BiFPN's, x *
    sigmoid(x)), like detectron2's Conv2d with `.norm`. bias is on iff there
    is no norm (dd3d_tpu ConvNorm)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = "BN", relu: bool = False, init: str = INIT_NORMAL_FAN_OUT, groups: int = 1,
                 swish: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride, bias=norm in ("", None), init=init,
                         groups=groups)
        self.norm = make_norm(norm, out_channels)
        self.relu, self.swish = relu, swish

    def takes_stem_kernel(self, x) -> bool:
        """Whether this conv runs on `x` (a tensor or NormalizedFrames)
        through the stem kernel in this call (ops/stem_conv.stem_conv_engages)."""
        if (self.kernel_size, self.stride, x.shape[1], self.weight.shape[0]) not in STEM_SHAPES:
            return False  # the rule's first test, before the quantization scope is read
        spec = _QUANT.get()
        foldable = self.norm is not None and self.norm.foldable
        return stem_conv_engages(
            device_type=x.device.type, training=self.training, grad=torch.is_grad_enabled(), foldable=foldable,
            relu=self.relu and not self.swish, dtype=x.dtype, groups=self.groups, kernel_size=self.kernel_size,
            stride=self.stride, in_channels=x.shape[1], out_channels=self.weight.shape[0],
            frames=isinstance(x, NormalizedFrames), quantizes=self.quantizes(spec, foldable, x.shape[1]),
            capture=spec.capture is not None)

    def forward(self, x):
        if self.takes_stem_kernel(x):
            spec = _QUANT.get()
            if spec.enabled and self.quantizable:
                _observe(spec, self.quant_path, x)  # the static-scale lookup, as on the F.conv2d path
            weight, bias = self._folded(*self.norm.folded())
            return stem_conv(x, weight.to(torch.bfloat16), bias.to(torch.bfloat16), self.stride)
        if isinstance(x, NormalizedFrames):
            x = x.normalized()  # DD3D.preprocess_image's tensor
        if self.norm is None:
            y = super().forward(x)
        elif self.norm.foldable:
            y = super().forward(x, *self.norm.folded())
        else:
            y = self.norm(super().forward(x))
        if self.swish:
            return F.silu(y)
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
    Reference names: `<tower>.<i>.weight`, `<tower>.<i>.norm.<level>.*`.

    `forward(x, level, consumer)` takes the conv that reads this one's
    output, when nothing else reads it: the next TowerConv of the tower, or
    the list of predictors fused after the last one. Where `link_amax`
    gives the consumer's static amax, the conv, its ReLU and the consumer's
    quantize run as one int8 conv with an s8 epilogue, and the result is a
    QuantizedActivation that the consumer reads in place of the tensor.

    With `bias` (FCOS2D `_VERSION=v1`) the conv adds a bias before the norm:
    folded, it enters the norm's add (bias * mul + add), on the fused link
    too; in train mode it is added before the live BN."""

    def __init__(self, channels: int, num_levels: int, norm: str, bias: bool = False):
        super().__init__(channels, channels, 3, bias=bias, init=INIT_NORMAL_FAN_OUT)
        self.norm = PerLevelNorms(num_levels, channels, norm)

    def link_amax(self, spec: QuantSpec, level: int, in_channels: int, out_shape, consumer) -> Optional[float]:
        """The consumer's static amax where this link fuses, else None. It
        fuses where this conv quantizes (its norm folded), the consumer
        quantizes (a TowerConv by the same rule, the predictors under
        QUANT_UNFOLDED), no calibration captures (it needs the bf16 maxima),
        and the consumer's path has a scale at the tag of this conv's
        output `out_shape` (NCHW). A read of `spec.scales` only: the
        consumer's `_observe` records a miss, once, as on the unfused path."""
        if consumer is None or spec.capture is not None or not spec.scales:
            return None
        if not (self.norm[level].foldable and self.quantizes(spec, True, in_channels)):
            return None
        if isinstance(consumer, TowerConv):
            if not consumer.quantizes(spec, consumer.norm[level].foldable, out_shape[1]):
                return None
            path = consumer.quant_path
        else:
            if not (spec.enabled and spec.unfolded):
                return None
            path = consumer[0].quant_path
        return spec.scales.get(path, {}).get(f"{out_shape[2]}x{out_shape[3]}x{out_shape[1]}")

    def forward(self, x, level: int, consumer=None):
        norm = self.norm[level]
        if norm.foldable:
            mul, add = norm.folded()
            amax = self.link_amax(_QUANT.get(), level, x.shape[1], (x.shape[0], self.weight.shape[0],
                                                                     x.shape[2], x.shape[3]), consumer)
            if amax is not None:
                return super().forward(x, mul, add, requant_amax=amax)
            return F.relu(super().forward(x, mul, add))
        return F.relu(norm(super().forward(x)))


def run_tower(convs, x, level: int, predictors=None):
    """A head tower's convs in turn on one level's features, each handed the
    conv that reads its output: the next one, and after the last the
    predictor group `predictors` (None where the tower's output has another
    reader, so that it stays a tensor). Returns the last conv's output, a
    QuantizedActivation where that link fused."""
    for i, conv in enumerate(convs):
        x = conv(x, level, convs[i + 1] if i + 1 < len(convs) else predictors)
    return x


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


def _stacked(preds):
    """(weight, bias) of sibling predictors concatenated along the output
    channels; a bias-free predictor gets a zero bias slice."""
    weight = preds[0].weight if len(preds) == 1 else torch.cat([m.weight for m in preds], 0)
    if all(m.bias is None for m in preds):
        return weight, None
    return weight, torch.cat([m.bias if m.bias is not None else m.weight.new_zeros(m.out_channels) for m in preds])


def fused_predictor_apply(x, preds):
    """Run sibling PredictorConvs as ONE conv over output-channel-concatenated
    kernels, then split. Exact: each output channel is computed as by its own
    conv; a bias-free predictor gets a zero bias slice (dd3d_tpu :457-515).
    Under TPU.QUANT_UNFOLDED the group is one int8 conv, keyed by the first
    sibling's scope path, whatever QUANT_MIN_CH is (:474-499); `x` may then
    be the QuantizedActivation of a fused tower link."""
    k = preds[0].kernel_size
    if any(m.kernel_size != k for m in preds):
        raise ValueError("fused predictors need one kernel size")
    spec = _QUANT.get()
    if spec.enabled and spec.unfolded:
        act_amax = _observe(spec, preds[0].quant_path, x)
        with annotate("int8.conv"):
            y = int8_conv_dequant(x, *_stacked(preds), 1, k // 2, x.dtype, act_amax, spec.plain)
    elif isinstance(x, QuantizedActivation):
        raise RuntimeError("a fused int8 link reached predictors that do not quantize")
    else:
        weight, bias = _stacked(preds)
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
