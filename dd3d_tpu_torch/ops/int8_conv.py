"""int8 convolution through the hand-written CUDA kernel
(dd3d_tpu_torch/csrc/int8_conv.cu), the port of
dd3d_tpu/models/layers.py::_int8_conv (:246-276), which XLA generates for
the TPU. PyTorch has no int8 convolution on CUDA.

- `int8_conv(xq, wq, scale, bias, stride, pad, out_dtype)`: int8 NHWC
  activations (B, H, W, C) and int8 OHWI weights (O, kh, kw, C), summed
  exactly in int32, then `out = cast_out(f32(acc) * scale[o])` and, with a
  bias, `out = out + cast_out(bias[o])` in `out_dtype` (layers.py:276 and
  :364-365). Returns NHWC (B, Ho, Wo, O). For CUDA tensors it launches the
  kernel (or raises); for CPU tensors it runs the plain PyTorch version,
  `int8_conv_plain`.
- `int8_conv_dequant(x, weight, bias, stride, pad, out_dtype, act_amax)`:
  the counterpart of `_int8_conv` as a whole (plus the bias), on the port's
  NCHW (channels_last) activations and OIHW fp32 weights: per-output-channel
  weight scales, the per-tensor activation scale (dynamic, or static from a
  calibrated `act_amax`), then the quantize kernel (ops/quantize.py) and the
  int8 conv kernel.
"""
import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_MAX_ELEMENTS = 2 ** 31 - 1  # the kernel indexes each tensor with 32-bit ints


def _out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def int8_conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Exact int32 accumulators (B, Ho, Wo, O) of the int8 conv, as an
    im2col GEMM in float64: every product and partial sum is an integer
    below 2^53 (|sum| <= 127^2 * K), so any summation order is exact, and the
    explicit unfold keeps the convolution library's algorithm choice (FFT,
    Winograd) out of it. One image at a time bounds the unfolded buffer."""
    b, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    ho, wo = _out_size(h, kh, stride, pad), _out_size(w, kw, stride, pad)
    wmat = wq.permute(0, 3, 1, 2).reshape(o, -1).double()  # (O, C*kh*kw), unfold's (c, r, s) order
    out = []
    for i in range(b):
        cols = F.unfold(xq[i:i + 1].permute(0, 3, 1, 2).double(), (kh, kw), padding=pad, stride=stride)
        out.append((wmat @ cols[0]).to(torch.int32).reshape(o, ho, wo))
    return torch.stack(out).permute(0, 2, 3, 1)


def dequant_plain(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's epilogue in PyTorch ops: f32(acc) * scale, cast, then the
    bias added in the output dtype."""
    y = (acc.float() * scale).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def int8_conv_plain(xq, wq, scale, bias, stride: int, pad: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version of `int8_conv`."""
    y = dequant_plain(int8_conv_acc_plain(xq, wq, stride, pad), scale, bias, out_dtype)
    return y.contiguous()


CHANNEL_MULTIPLE = 16  # the kernel stages 16-byte chunks, each within one (r, s) tap


def pad_channels(xq: torch.Tensor, wq: torch.Tensor):
    """xq (B, H, W, C) and wq (O, kh, kw, C) with zero channels appended up to
    C % CHANNEL_MULTIPLE == 0 (an explicit copy; of the path's convs only
    the 3-channel stem needs it). Zero codes add nothing to the sums."""
    extra = -xq.shape[3] % CHANNEL_MULTIPLE
    if not extra:
        return xq, wq
    return F.pad(xq, (0, extra)), F.pad(wq, (0, extra))


_lib = None


def _library():
    global _lib
    if _lib is None:
        from dd3d_tpu_torch.kernels import load_library

        lib = load_library("int8_conv.cu")
        lib.dd3d_int8_conv.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.dd3d_int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(xq, wq, scale, bias, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"need int8 activations and weights; got {xq.dtype}, {wq.dtype}")
    if xq.ndim != 4 or wq.ndim != 4 or wq.shape[3] != xq.shape[3]:
        raise ValueError(f"need xq (B, H, W, C) and wq (O, kh, kw, C); got {tuple(xq.shape)}, {tuple(wq.shape)}")
    o = wq.shape[0]
    if scale.dtype != torch.float32 or scale.shape != (o,):
        raise ValueError(f"need a float32 scale of shape ({o},); got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (o,)):
        raise ValueError(f"need a float32 bias of shape ({o},); got {bias.dtype} {tuple(bias.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32; got {out_dtype}")
    tensors = [xq, wq, scale] + ([] if bias is None else [bias])
    if any(t.device != xq.device for t in tensors):
        raise ValueError("xq, wq, scale and bias must be on one device")


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              stride: int, pad: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Dequantized int8 conv (B, Ho, Wo, O); see the module docstring.
    `int8_conv.launches` counts kernel launches."""
    _check(xq, wq, scale, bias, out_dtype)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, scale, bias, stride, pad, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    tensors = [xq, wq, scale] + ([] if bias is None else [bias])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("xq, wq, scale and bias must be contiguous (xq NHWC, wq OHWI)")
    b, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    xq, wq = pad_channels(xq, wq)
    ho, wo = _out_size(h, kh, stride, pad), _out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for input {h}x{w}, kernel {kh}x{kw}, stride {stride}, pad {pad}")
    if max(xq.numel(), wq.numel(), b * ho * wo * o) > _MAX_ELEMENTS:
        raise ValueError("a tensor exceeds the kernel's 2^31-element limit")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned")
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _library().dd3d_int8_conv(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, xq.shape[3], o, kh, kw, stride, pad, stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: error {err}")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def activation_scale(x: torch.Tensor, act_amax: Optional[float]) -> torch.Tensor:
    """The per-tensor activation scale `xs` as a one-element f32 tensor on
    x's device: max(amax, 1e-12) / 127 in f32 (layers.py:259-262). A static
    amax (a double from JSON) is cast to f32 before the max and the divide;
    the dynamic amax is max|x|, a torch reduction (exact in any order)."""
    if act_amax is None:
        amax = x.abs().amax().float()
        return (torch.clamp(amax, min=1e-12) / 127.0).reshape(1)
    xs = np.maximum(np.float32(act_amax), np.float32(1e-12)) / np.float32(127.0)
    return torch.full((1,), float(xs), dtype=torch.float32, device=x.device)


def quantize_weight(weight: torch.Tensor):
    """(wq OHWI int8, ws (O,) f32): symmetric per-output-channel scales
    max(max|w|, 1e-12) / 127 and codes clip(round(w / ws), +-127), from the
    fp32 (norm-folded) OIHW weight (layers.py:264-265)."""
    ws = torch.clamp(weight.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(weight / ws[:, None, None, None]), -127, 127).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), ws


def int8_conv_dequant(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: int, pad: int,
                      out_dtype: torch.dtype, act_amax: Optional[float] = None, plain: bool = False) -> torch.Tensor:
    """The port of `_int8_conv` plus the bias: x (B, C, H, W), weight
    (O, C, kh, kw) fp32, bias (O,) fp32 or None; returns (B, O, Ho, Wo) in
    `out_dtype` with channels_last strides. `plain` runs the kernels' plain
    versions (on any device), for checking the kernels against them."""
    x_nhwc = x.permute(0, 2, 3, 1)
    if not x_nhwc.is_contiguous():
        x_nhwc = x_nhwc.contiguous()  # an explicit copy to NHWC; the kernels take no other layout
    xs = activation_scale(x_nhwc, act_amax)
    wq, ws = quantize_weight(weight.float())
    scale = xs * ws  # the (O,) f32 vector first, as layers.py:276
    bias = None if bias is None else bias.float()
    quantize, conv = (quantize_int8_plain, int8_conv_plain) if plain else (quantize_int8, int8_conv)
    xq = quantize(x_nhwc, xs)
    y = conv(xq, wq, scale, bias, stride, pad, out_dtype)
    return y.permute(0, 3, 1, 2)
