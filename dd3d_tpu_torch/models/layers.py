"""Building-block layers: conv+norm+act, frozen BN, learnable Scale/Offset.

Counterpart of dd3d_tpu/models/layers.py, for inference:
- Modules take NCHW tensors (channels_last in memory when the caller feeds
  NHWC images, see models/dd3d.py) and compute in the dtype of the activation
  they are given; parameters stay fp32.
- Parameter and buffer names are the reference checkpoints' (detectron2's
  Conv2d with a `.norm` child; BatchNorm2d's weight / bias / running_mean /
  running_var / num_batches_tracked), as in tests/torch_ref_dd3d.py, so a
  reference state dict loads with `load_state_dict(strict=True)`.
- Every norm is folded into the preceding conv: the kernel is scaled by the
  norm's per-channel `mul` in fp32 and only then cast to the compute dtype
  (dd3d_tpu/models/layers.py:307-309). Folding after the cast gives other
  bf16 weights.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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

    def forward(self, x):
        # The folded affine in the ACTIVATION dtype, like d2's FrozenBatchNorm2d.
        mul, add = self.folded()
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
    """Live BatchNorm at inference: the running-stat affine, with rsqrt like
    the JAX module (:84-88). Train mode belongs to the training slice."""

    def folded(self):
        if self.training:
            raise NotImplementedError("train-mode BatchNorm is not ported; call model.eval()")
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul


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
    norm(conv(x) + b) == conv_{W*mul}(x) + (b*mul + add)."""

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

    def forward(self, x, mul=None, add=None):
        weight, bias = self.weight, self.bias
        if mul is not None:
            weight = weight * mul[:, None, None, None]  # fp32, before the cast
            bias = bias * mul + add if bias is not None else add
        return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                        self.stride, (self.kernel_size - 1) // 2)


class ConvNorm(FoldableConv):
    """Conv -> norm (folded) -> optional relu, like detectron2's Conv2d with
    `.norm`. bias is on iff there is no norm (dd3d_tpu ConvNorm)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = "BN", relu: bool = False, init: str = INIT_NORMAL_FAN_OUT):
        super().__init__(in_channels, out_channels, kernel_size, stride, bias=norm in ("", None), init=init)
        self.norm = make_norm(norm, out_channels)
        self.relu = relu

    def forward(self, x):
        y = super().forward(x) if self.norm is None else super().forward(x, *self.norm.folded())
        return F.relu(y) if self.relu else y


class PerLevelNorms(nn.ModuleList):
    """One norm per FPN level, chosen by an explicit level index (the
    reference's round-robin `ModuleListDial` without its hidden state)."""

    def __init__(self, num_levels: int, features: int, norm: str):
        if norm in ("", None):
            raise NotImplementedError("per-level norms need a norm (BN or FrozenBN)")
        super().__init__([make_norm(norm, features) for _ in range(num_levels)])

    def folded(self, level: int):
        return self[level].folded()

    def forward(self, x, level: int):
        return self[level](x)


class TowerConv(FoldableConv):
    """A head-tower layer: one conv shared by all levels, each level's norm
    folded into its own application of the kernel (never averaged), then relu.
    Reference names: `<tower>.<i>.weight`, `<tower>.<i>.norm.<level>.*`."""

    def __init__(self, channels: int, num_levels: int, norm: str):
        super().__init__(channels, channels, 3, init=INIT_NORMAL_FAN_OUT)
        self.norm = PerLevelNorms(num_levels, channels, norm)

    def forward(self, x, level: int):
        return F.relu(super().forward(x, *self.norm.folded(level)))


class PredictorConv(nn.Module):
    """A head's 3x3 predictor conv (weight + optional bias); siblings reading
    the same map run as one conv through `fused_predictor_apply`."""

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
    conv; a bias-free predictor gets a zero bias slice (dd3d_tpu :457-515)."""
    k = preds[0].kernel_size
    if any(m.kernel_size != k for m in preds):
        raise ValueError("fused predictors need one kernel size")
    weight = preds[0].weight if len(preds) == 1 else torch.cat([m.weight for m in preds], 0)
    bias = None
    if any(m.bias is not None for m in preds):
        bias = torch.cat([m.bias if m.bias is not None else m.weight.new_zeros(m.out_channels)
                          for m in preds])
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
