"""Per-tensor symmetric int8 quantize through the hand-written CUDA kernel
(dd3d_tpu_torch/csrc/quantize.cu), the port of the Pallas quantize kernel
(scripts/bench_quantize_kernel.py::make_pallas) and of the quantize step of
dd3d_tpu/models/layers.py::_int8_conv (:255-263).

`quantize_int8(x, xs)` takes a contiguous bf16 or f32 tensor (an NHWC
activation) and the scale `xs`, a one-element f32 tensor on the same device,
and returns `clip(round_half_even(f32(x) / xs), -127, 127)` as int8, in the
shape of `x`:
- for CUDA tensors it launches the kernel (or raises: there is no fallback);
- for CPU tensors it runs the plain PyTorch version, `quantize_int8_plain`,
  which the CPU tests and chip_smoke.py hold the kernel against.
Both divide by `xs`, as the package's serving path does; the Pallas kernel
multiplies by 1/xs, which gives the other code next to a .5 tie.
"""
import ctypes

import torch

_DTYPES = (torch.bfloat16, torch.float32)


def quantize_int8_plain(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (torch.round rounds half to even)."""
    return torch.clamp(torch.round(x.float() / xs.reshape(())), -127, 127).to(torch.int8)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from dd3d_tpu_torch.kernels import load_library

        lib = load_library("quantize.cu")
        lib.dd3d_quantize_int8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_longlong, ctypes.c_void_p]
        lib.dd3d_quantize_int8.restype = ctypes.c_int
        _lib = lib
    return _lib


def quantize_int8(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """int8 codes of `x` at scale `xs`; see the module docstring.
    `quantize_int8.launches` counts kernel launches."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"need a bfloat16 or float32 activation; got {x.dtype}")
    if xs.dtype != torch.float32 or xs.numel() != 1:
        raise TypeError(f"need a one-element float32 scale; got {xs.dtype} with {xs.numel()} elements")
    if xs.device != x.device:
        raise ValueError(f"x on {x.device}, xs on {xs.device}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x, xs)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    if not (x.is_contiguous() and xs.is_contiguous()):
        raise ValueError("x must be contiguous (the kernel walks it as a flat NHWC buffer)")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().dd3d_quantize_int8(x.data_ptr(), int(x.dtype == torch.bfloat16), xs.data_ptr(),
                                            q.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    quantize_int8.launches += 1
    return q


quantize_int8.launches = 0
