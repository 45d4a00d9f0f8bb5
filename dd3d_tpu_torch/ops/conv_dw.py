"""Weight gradient of a stride-1 SAME conv through the hand-written CUDA
kernel (dd3d_tpu_torch/csrc/conv_dw.cu), the port of
dd3d_tpu/ops/pallas_conv.py (conv_dw_s1_same_pallas and the conv2d_s1_same
custom_vjp).

`conv_dw_s1_same(x, dy, k)` takes x (B, CI, H, W) and dy (B, CO, H, W), both
channels_last in memory, bf16 or f32 of one dtype, and an odd k <= 9, and
returns dW (CO, CI, k, k) in f32:
- for CUDA tensors it launches the kernel (or raises: there is no fallback);
- for CPU tensors it runs the plain PyTorch version, `conv_dw_s1_same_plain`,
  which the CPU tests and chip_smoke.py hold the kernel against.

`Conv2dS1Same` is the autograd Function that the DLA stem routes its
stride-1 convs through under TPU.PALLAS_STEM_DW: forward F.conv2d, dx the
library transposed conv, dW the kernel, cast to the weight's dtype.
"""
import ctypes

import torch
import torch.nn.functional as F

_DTYPES = (torch.bfloat16, torch.float32)


def check_kernel_size(k: int) -> None:
    if k % 2 != 1 or not 1 <= k <= 9:
        raise ValueError(f"the stride-1 SAME weight-gradient kernel takes an odd k <= 9; got {k}")


def conv_dw_s1_same_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version: for each of the k*k taps, one explicit f32
    contraction over the B*H*W pixels of the shifted input with dy."""
    check_kernel_size(k)
    p = (k - 1) // 2
    b, co, h, w = dy.shape
    xp = F.pad(x.float(), (p, p, p, p))
    dyt = dy.float().permute(1, 0, 2, 3).reshape(co, -1)  # (CO, P)
    out = torch.empty((co, x.shape[1], k, k), dtype=torch.float32, device=x.device)
    for dh in range(k):
        for dw in range(k):
            xs = xp[:, :, dh:dh + h, dw:dw + w].permute(1, 0, 2, 3).reshape(x.shape[1], -1)  # (CI, P)
            out[:, :, dh, dw] = dyt @ xs.t()
    return out


_lib = None


def _library():
    global _lib
    if _lib is None:
        from dd3d_tpu_torch.kernels import load_library

        lib = load_library("conv_dw.cu")
        lib.dd3d_conv_dw_workspace.argtypes = [ctypes.c_int] * 6
        lib.dd3d_conv_dw_workspace.restype = ctypes.c_longlong
        lib.dd3d_conv_dw_s1_same.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
                                             + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        lib.dd3d_conv_dw_s1_same.restype = ctypes.c_int
        _lib = lib
    return _lib


def conv_dw_s1_same(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (CO, CI, k, k) f32; see the module docstring.
    `conv_dw_s1_same.launches` counts kernel launches."""
    check_kernel_size(k)
    if x.ndim != 4 or dy.ndim != 4 or x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"need x (B, CI, H, W) and dy (B, CO, H, W); got {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"need bfloat16 or float32 x and dy of one dtype; got {x.dtype}, {dy.dtype}")
    if x.device != dy.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    if x.device.type == "cpu":
        return conv_dw_s1_same_plain(x, dy, k)
    if x.device.type != "cuda":
        raise ValueError(f"no weight-gradient kernel for device {x.device}")
    cl = torch.channels_last
    if not (x.is_contiguous(memory_format=cl) and dy.is_contiguous(memory_format=cl)):
        raise ValueError("x and dy must be channels_last-contiguous (the kernel reads NHWC)")
    b, ci, h, w = x.shape
    co = dy.shape[1]
    lib = _library()
    ws_floats = lib.dd3d_conv_dw_workspace(b, h, w, ci, co, k)
    if ws_floats < 0:
        raise ValueError(f"x {tuple(x.shape)} with k={k}: the halo tile exceeds the kernel's shared memory")
    workspace = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
    out = torch.empty((co, ci, k, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dd3d_conv_dw_s1_same(x.data_ptr(), dy.data_ptr(), int(x.dtype == torch.bfloat16), b, h, w, ci,
                                       co, k, workspace.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"weight-gradient kernel launch failed: cudaError {err}")
    conv_dw_s1_same.launches += 1
    return out


conv_dw_s1_same.launches = 0


class Conv2dS1Same(torch.autograd.Function):
    """Stride-1 SAME conv of x (B, CI, H, W) with weight (CO, CI, k, k), odd
    k, no bias: the counterpart of the conv2d_s1_same custom_vjp
    (pallas_conv.py:175-199). Forward and dx are the library's convs; dW is
    `conv_dw_s1_same` (`conv_dw_s1_same_plain` with `plain`, on any
    device), cast to the weight's dtype (bf16 for a bf16 forward, as JAX
    casts it, :195), and dx is skipped when x needs no gradient (the
    image)."""

    @staticmethod
    def forward(ctx, x, weight, plain=False):
        k = weight.shape[-1]
        check_kernel_size(k)
        ctx.save_for_backward(x, weight)
        ctx.plain = plain
        return F.conv2d(x, weight, None, 1, (k - 1) // 2)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        k = weight.shape[-1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv_transpose2d(dy, weight, None, 1, (k - 1) // 2)
        if ctx.needs_input_grad[1]:
            cl = torch.channels_last
            weight_grad = conv_dw_s1_same_plain if ctx.plain else conv_dw_s1_same
            dw = weight_grad(x.contiguous(memory_format=cl), dy.contiguous(memory_format=cl), k).to(weight.dtype)
        return dx, dw, None
