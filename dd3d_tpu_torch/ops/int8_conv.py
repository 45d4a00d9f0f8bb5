"""int8 convolution through the hand-written CUDA kernel
(dd3d_tpu_torch/csrc/int8_conv.cu), the port of
dd3d_tpu/models/layers.py::_int8_conv (:246-276), which XLA generates for
the TPU. PyTorch has no int8 convolution on CUDA.

- `int8_conv(xq, wq, scale, bias, stride, pad, out_dtype)`: int8 NHWC
  activations (B, H, W, C) and int8 OHWI weights (O, kh, kw, C), summed
  exactly in int32, then `out = cast_out(f32(acc) * scale[o])` and, with a
  bias, `out = out + cast_out(bias[o])` in `out_dtype` (layers.py:276 and
  :364-365). Returns NHWC (B, Ho, Wo, O). For CUDA tensors it launches the
  kernel (or raises), once per run of images when a tensor would exceed the
  kernel's 2^31 elements (`batch_chunks`: a TTA bucket of 160 instances at
  640x1920 does); for CPU tensors it runs the plain PyTorch version,
  `int8_conv_plain`. With `requant=xs_next` (a one-element f32 tensor) it
  returns the next conv's NHWC int8 codes instead,
  `quantize_int8(relu(out), xs_next)` computed in the kernel's epilogue
  (`int8_conv_requant_plain` on the CPU): a head tower's link from one int8
  conv to the next, with no bf16 tensor in between.
- `int8_conv_grouped(xq, wq, scale, bias, stride, pad, out_dtype, groups)`:
  the same with feature_group_count = groups > 1 (layers.py:273), wq
  (O, kh, kw, C / groups): output channel o sums over the input channels of
  its group only, with the same epilogue. CUDA tensors launch one of the
  grouped kernels of the same source, chosen by shape (`grouped_route`):
  `depthwise` (C/g = 1, O = C: BiFPN's `dw` convs, a shared-memory tile on
  the CUDA cores), `mma` (C/g = 16 or 32, O/g a multiple of 8: RegNet's
  Y-block `b` convs, an implicit GEMM a group on the tensor cores), `narrow`
  (C/g = O/g = 2, 4 or 8: DLA-X's BottleneckX 3x3, the depthwise tile with
  __dp4a over whole groups) or `direct` (any shape, a direct conv on the
  CUDA cores); `route=` forces one the shape admits. CPU tensors run
  `int8_conv_grouped_plain`.
- `int8_conv_dequant(x, weight, bias, stride, pad, out_dtype, act_amax,
  groups=1, requant_amax=None)`: the counterpart of `_int8_conv` as a whole
  (plus the bias), on the port's NCHW (channels_last) activations and OIHW
  fp32 weights: per-output-channel weight scales, the per-tensor activation
  scale (dynamic, or static from a calibrated `act_amax`), then the quantize
  kernel (ops/quantize.py) and the int8 conv kernel, grouped or not. `x`
  may be a `QuantizedActivation`, the codes a previous conv's s8 epilogue
  wrote: the quantize is then skipped. With `requant_amax` (the next conv's
  static amax) it returns such a holder: ReLU and the next quantize fused
  into this conv's epilogue.
"""
import ctypes
from dataclasses import dataclass
from typing import Optional, Union

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


def int8_conv_requant_plain(xq, wq, scale, bias, stride: int, pad: int, out_dtype: torch.dtype,
                            xs_next: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `int8_conv(..., requant=xs_next)`: the
    unfused composition, the dequantized conv in `out_dtype`, its ReLU, then
    the next conv's quantize at `xs_next`. NHWC int8."""
    return quantize_int8_plain(F.relu(int8_conv_plain(xq, wq, scale, bias, stride, pad, out_dtype)), xs_next)


def int8_conv_grouped_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int,
                                groups: int) -> torch.Tensor:
    """Exact int32 accumulators (B, Ho, Wo, O) of the grouped int8 conv: the
    im2col of `int8_conv_acc_plain`, cut into the groups' rows, and one
    batched f64 product a group (integers below 2^53, so exact in any order,
    on the CPU and on the card alike)."""
    b, h, w, c = xq.shape
    o, kh, kw, cg = wq.shape
    if c != cg * groups or o % groups:
        raise ValueError(f"{groups} groups do not divide xq {tuple(xq.shape)} and wq {tuple(wq.shape)}")
    ho, wo = _out_size(h, kh, stride, pad), _out_size(w, kw, stride, pad)
    wmat = wq.permute(0, 3, 1, 2).reshape(groups, o // groups, cg * kh * kw).double()
    out = []
    for i in range(b):
        cols = F.unfold(xq[i:i + 1].permute(0, 3, 1, 2).double(), (kh, kw), padding=pad, stride=stride)
        cols = cols[0].reshape(groups, cg * kh * kw, ho * wo)  # unfold's rows are (c, r, s), c slowest
        out.append(torch.bmm(wmat, cols).to(torch.int32).reshape(o, ho, wo))
    return torch.stack(out).permute(0, 2, 3, 1)


def int8_conv_grouped_plain(xq, wq, scale, bias, stride: int, pad: int, out_dtype: torch.dtype,
                            groups: int) -> torch.Tensor:
    """The plain PyTorch version of `int8_conv_grouped`."""
    y = dequant_plain(int8_conv_grouped_acc_plain(xq, wq, stride, pad, groups), scale, bias, out_dtype)
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
        lib.dd3d_int8_conv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p])
        lib.dd3d_int8_conv.restype = ctypes.c_int
        lib.dd3d_int8_conv_grouped.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        lib.dd3d_int8_conv_grouped.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(xq, wq, scale, bias, out_dtype, groups=1):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"need int8 activations and weights; got {xq.dtype}, {wq.dtype}")
    if xq.ndim != 4 or wq.ndim != 4 or wq.shape[3] * groups != xq.shape[3] or wq.shape[0] % groups:
        raise ValueError(f"need xq (B, H, W, C) and wq (O, kh, kw, C/{groups}) with O a multiple of {groups}; "
                         f"got {tuple(xq.shape)}, {tuple(wq.shape)}")
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


OUT_KINDS = ("f32", "bf16", "s8")  # int8_conv.launches_by_out's keys


def _out_kind(out_dtype: torch.dtype, requant: Optional[torch.Tensor]) -> int:
    """The C entry's out_kind: 0 f32, 1 bf16, 2 s8 after a bf16 epilogue, 3
    s8 after an f32 one."""
    bf16 = int(out_dtype == torch.bfloat16)
    return bf16 if requant is None else 3 - bf16


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              stride: int, pad: int, out_dtype: torch.dtype, requant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantized int8 conv (B, Ho, Wo, O), or with `requant` the next
    conv's int8 codes of its ReLU; see the module docstring.
    `int8_conv.launches` counts kernel launches, `int8_conv.launches_by_out`
    the same by output kind (`OUT_KINDS`)."""
    _check(xq, wq, scale, bias, out_dtype)
    if requant is not None and (requant.dtype != torch.float32 or requant.numel() != 1
                                or requant.device != xq.device):
        raise ValueError(f"requant must be a one-element float32 scale on {xq.device}; got {requant.dtype} with "
                         f"{requant.numel()} elements on {requant.device}")
    if xq.device.type == "cpu":
        if requant is not None:
            return int8_conv_requant_plain(xq, wq, scale, bias, stride, pad, out_dtype, requant)
        return int8_conv_plain(xq, wq, scale, bias, stride, pad, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    tensors = [xq, wq, scale] + ([] if bias is None else [bias])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("xq, wq, scale and bias must be contiguous (xq NHWC, wq OHWI)")
    b, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    kind = _out_kind(out_dtype, requant)
    xq, wq = pad_channels(xq, wq)
    ho, wo = _out_size(h, kh, stride, pad), _out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for input {h}x{w}, kernel {kh}x{kw}, stride {stride}, pad {pad}")
    if wq.numel() > _MAX_ELEMENTS:
        raise ValueError("the weight exceeds the kernel's 2^31-element limit")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned")
    c = xq.shape[3]
    out = torch.empty((b, ho, wo, o), dtype=out_dtype if requant is None else torch.int8, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        for i0, i1 in batch_chunks(b, max(h * w * c, ho * wo * o)):
            # each chunk's images start 16-byte aligned: h*w*c is a multiple of 16
            err = _library().dd3d_int8_conv(
                xq[i0:i1].data_ptr(), wq.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
                out[i0:i1].data_ptr(), kind, None if requant is None else requant.data_ptr(), i1 - i0, h, w, c, o,
                kh, kw, stride, pad, stream)
            if err != 0:
                raise RuntimeError(f"int8 conv kernel launch failed: error {err}")
            int8_conv.launches += 1
            int8_conv.launches_by_out[OUT_KINDS[min(kind, 2)]] += 1
    return out


def batch_chunks(batch: int, per_image: int, limit: int = _MAX_ELEMENTS):
    """[(start, stop)] splitting `batch` images into as few equal-sized
    runs as keep each run's `per_image * images` elements within `limit`
    (the kernel's 32-bit indexing): one launch a run. The images of a conv
    are independent, so the runs give the whole batch's result."""
    if per_image > limit:
        raise ValueError("one image exceeds the kernel's 2^31-element limit")
    per_run = max(1, limit // per_image)
    runs = -(-batch // per_run)
    size = -(-batch // runs)
    return [(i, min(i + size, batch)) for i in range(0, batch, size)]


int8_conv.launches = 0
int8_conv.launches_by_out = dict.fromkeys(OUT_KINDS, 0)


GROUPED_ROUTES = ("direct", "depthwise", "mma", "narrow")  # the C entry's route codes 0, 1, 2, 3


def grouped_routes(c: int, o: int, kh: int, kw: int, stride: int, groups: int):
    """The routes of csrc/int8_conv.cu's grouped conv that take this shape,
    the preferred first; `direct` takes every shape. `depthwise`: one input
    and one output channel a group, C % 16 == 0; `mma`: C/g of 16 or 32,
    O/g a multiple of 8 up to 64; `narrow`: C/g = O/g of 2, 4 or 8,
    C % 16 == 0; all three 3x3 at stride 1 or 2."""
    cg, og = c // groups, o // groups
    tiled = kh == 3 and kw == 3 and stride in (1, 2)
    routes = []
    if tiled and cg == 1 and og == 1 and c % 16 == 0:
        routes.append("depthwise")
    if tiled and cg in (16, 32) and og % 8 == 0 and og <= 64:
        routes.append("mma")
    if tiled and cg in (2, 4, 8) and og == cg and c % 16 == 0:
        routes.append("narrow")
    return tuple(routes) + ("direct",)


def grouped_route(c: int, o: int, kh: int, kw: int, stride: int, groups: int) -> str:
    """The route `int8_conv_grouped` launches for this shape."""
    return grouped_routes(c, o, kh, kw, stride, groups)[0]


def int8_conv_grouped(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: int, pad: int, out_dtype: torch.dtype, groups: int,
                      route: Optional[str] = None) -> torch.Tensor:
    """Dequantized grouped int8 conv (B, Ho, Wo, O) of xq (B, H, W, C) and wq
    (O, kh, kw, C / groups); see the module docstring. `route` (default
    `grouped_route`'s choice) names the kernel, and raises if the shape does
    not admit it. `int8_conv_grouped.launches` counts kernel launches,
    `int8_conv_grouped.launches_by_route` the same by route."""
    _check(xq, wq, scale, bias, out_dtype, groups)
    b, h, w, c = xq.shape
    o, kh, kw, _ = wq.shape
    admitted = grouped_routes(c, o, kh, kw, stride, groups)
    route = admitted[0] if route is None else route
    if route not in admitted:
        raise ValueError(f"the grouped int8 conv's {route!r} route does not take C={c}, O={o}, {kh}x{kw}, "
                         f"stride {stride}, {groups} groups (it takes {admitted})")
    if xq.device.type == "cpu":
        return int8_conv_grouped_plain(xq, wq, scale, bias, stride, pad, out_dtype, groups)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    tensors = [xq, wq, scale] + ([] if bias is None else [bias])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("xq, wq, scale and bias must be contiguous (xq NHWC, wq OHWI)")
    ho, wo = _out_size(h, kh, stride, pad), _out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for input {h}x{w}, kernel {kh}x{kw}, stride {stride}, pad {pad}")
    if wq.numel() > _MAX_ELEMENTS:
        raise ValueError("the weight exceeds the kernel's 2^31-element limit")
    if route != "direct" and (xq.data_ptr() % 16 or wq.data_ptr() % 16):
        raise ValueError(f"the {route} route needs xq and wq 16-byte aligned")
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        for i0, i1 in batch_chunks(b, max(h * w * c, ho * wo * o)):
            # the tiled routes take C % 16 == 0 and O % 8 == 0, so each run's
            # images start 16-byte aligned
            err = _library().dd3d_int8_conv_grouped(
                xq[i0:i1].data_ptr(), wq.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
                out[i0:i1].data_ptr(), int(out_dtype == torch.bfloat16), i1 - i0, h, w, c, o, kh, kw, stride, pad,
                groups, GROUPED_ROUTES.index(route), stream)
            if err != 0:
                raise RuntimeError(f"grouped int8 conv kernel ({route}) launch failed: error {err}")
            int8_conv_grouped.launches += 1
            int8_conv_grouped.launches_by_route[route] += 1
    return out


int8_conv_grouped.launches = 0
int8_conv_grouped.launches_by_route = dict.fromkeys(GROUPED_ROUTES, 0)


def static_scale(act_amax: float) -> float:
    """The scale of a static amax: max(f32(amax), 1e-12) / 127 in f32
    (layers.py:259-260; the amax is a double from JSON)."""
    return float(np.maximum(np.float32(act_amax), np.float32(1e-12)) / np.float32(127.0))


def activation_scale(x: torch.Tensor, act_amax: Optional[float]) -> torch.Tensor:
    """The per-tensor activation scale `xs` as a one-element f32 tensor on
    x's device: max(amax, 1e-12) / 127 in f32 (layers.py:259-262). A static
    amax is `static_scale`; the dynamic amax is max|x|, a torch reduction
    (exact in any order)."""
    if act_amax is None:
        amax = x.abs().amax().float()
        return (torch.clamp(amax, min=1e-12) / 127.0).reshape(1)
    return torch.full((1,), static_scale(act_amax), dtype=torch.float32, device=x.device)


@dataclass(frozen=True)
class QuantizedActivation:
    """An activation held as the int8 codes that the conv before it wrote in
    its s8 epilogue, for the conv that reads it: `codes` (B, H, W, C) NHWC
    int8, `xs` the one-element f32 scale tensor they were made at (on the
    codes' device), `xs_value` the same scale as a float, and `dtype` the
    activation's dtype on the unfused path (the consumer's output dtype).
    `shape` is the activation's NCHW shape, as the modules see it."""

    codes: torch.Tensor
    xs: torch.Tensor
    xs_value: float
    dtype: torch.dtype

    @property
    def shape(self) -> torch.Size:
        b, h, w, c = self.codes.shape
        return torch.Size((b, c, h, w))


def quantize_weight(weight: torch.Tensor):
    """(wq OHWI int8, ws (O,) f32): symmetric per-output-channel scales
    max(max|w|, 1e-12) / 127 and codes clip(round(w / ws), +-127), from the
    fp32 (norm-folded) OIHW weight (layers.py:264-265)."""
    ws = torch.clamp(weight.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(weight / ws[:, None, None, None]), -127, 127).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), ws


def int8_conv_dequant(x: Union[torch.Tensor, QuantizedActivation], weight: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: int, pad: int, out_dtype: torch.dtype, act_amax: Optional[float] = None,
                      plain: bool = False, groups: int = 1,
                      requant_amax: Optional[float] = None) -> Union[torch.Tensor, QuantizedActivation]:
    """The port of `_int8_conv` plus the bias: x (B, C, H, W), weight
    (O, C / groups, kh, kw) fp32, bias (O,) fp32 or None; returns
    (B, O, Ho, Wo) in `out_dtype` with channels_last strides. `plain` runs
    the kernels' plain versions (on any device), for checking the kernels
    against them.

    A `QuantizedActivation` x skips the quantize: its codes are the conv's
    input. Its scale must be the one this conv's static `act_amax` gives
    (else ValueError: the producer looked up another amax). With
    `requant_amax` (ungrouped convs only), the result is the
    QuantizedActivation of ReLU(this conv's output) at the scale of that
    static amax, written by the int8 conv's s8 epilogue."""
    if isinstance(x, QuantizedActivation):
        if act_amax is None or static_scale(act_amax) != x.xs_value:
            raise ValueError(f"the quantized activation was made at scale {x.xs_value!r}; this conv's static amax "
                             f"{act_amax!r} gives {None if act_amax is None else static_scale(act_amax)!r}")
        xq, xs = x.codes, x.xs
    else:
        x_nhwc = x.permute(0, 2, 3, 1)
        if not x_nhwc.is_contiguous():
            x_nhwc = x_nhwc.contiguous()  # an explicit copy to NHWC; the kernels take no other layout
        xs = activation_scale(x_nhwc, act_amax)
        xq = None
    wq, ws = quantize_weight(weight.float())
    scale = xs * ws  # the (O,) f32 vector first, as layers.py:276
    bias = None if bias is None else bias.float()
    if xq is None:
        xq = (quantize_int8_plain if plain else quantize_int8)(x_nhwc, xs)
    if requant_amax is not None:
        if groups != 1:
            raise ValueError("the s8 epilogue is the ungrouped int8 conv's only")
        xs_value = static_scale(requant_amax)
        xs_next = torch.full((1,), xs_value, dtype=torch.float32, device=xq.device)
        if plain:
            codes = int8_conv_requant_plain(xq, wq, scale, bias, stride, pad, out_dtype, xs_next)
        else:
            codes = int8_conv(xq, wq, scale, bias, stride, pad, out_dtype, requant=xs_next)
        return QuantizedActivation(codes, xs_next, xs_value, out_dtype)
    if groups == 1:
        y = (int8_conv_plain if plain else int8_conv)(xq, wq, scale, bias, stride, pad, out_dtype)
    else:
        y = (int8_conv_grouped_plain if plain else int8_conv_grouped)(xq, wq, scale, bias, stride, pad, out_dtype,
                                                                       groups)
    return y.permute(0, 3, 1, 2)
