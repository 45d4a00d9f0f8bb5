"""DLA's full-resolution stem convs through the hand-written CUDA kernel
(dd3d_tpu_torch/csrc/stem_conv.cu): the conv, its folded-BN bias and its
ReLU in one launch, the first conv reading the uint8 frames and normalizing
them as it loads them. It replaces no TPU kernel: the JAX package leaves
these convs to XLA.

- `stem_conv(x, weight, bias, stride)`: relu(conv(x, weight) + bias) at one
  of the three `STEM_SHAPES` (DLA's `base_layer`, `level0`, `level1`), x
  either `NormalizedFrames` (the 7x7 conv) or an NCHW bf16 tensor (the 3x3
  convs), weight (O, C, k, k) and bias (O,) bf16; returns NCHW bf16 with
  channels_last strides. For CUDA tensors it launches the kernel (or
  raises), once per run of images where a tensor would exceed 2^31
  elements (`batch_chunks`: a TTA bucket of 160 instances at 640x1920
  does); for CPU tensors it runs `stem_conv_plain`.
- `stem_conv_plain`: the unfused path's composition, which the kernel
  repeats: the frames normalized as DD3D.preprocess_image does, F.conv2d in
  f32 (TF32 off) on the bf16 operands, the sum rounded to bf16 (cuDNN's bf16
  output), the bf16 bias added (PyTorch's separate add_: f32, rounded to
  bf16), then the ReLU.
- `stem_conv_engages`: the rule that sends a conv to the kernel, a pure
  function of what the caller can see.
- `NormalizedFrames`: the frames, mean, std and dtype that DD3D.forward
  hands a trunk that reads frames (DLA's) in place of the normalized
  tensor; its first ConvNorm normalizes them in the kernel's load, or
  calls `normalized()` where the rule does not hold.
"""
import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from dd3d_tpu_torch.ops.int8_conv import batch_chunks

# (kernel size, stride, input channels, output channels) -> the C entry's kind
STEM_SHAPES = {(7, 1, 3, 16): 0, (3, 1, 16, 16): 1, (3, 2, 16, 32): 2}
FRAMES_KIND = 0  # the kind that reads the frames


@dataclass(frozen=True)
class NormalizedFrames:
    """(B, H, W, 3) BGR frames (uint8 for the kernel) standing for
    ((frames - mean) / std) in f32, rounded to `dtype`, as NCHW: what
    DD3D.preprocess_image computes. `mean` and `std` are the model's f32
    (1, 3, 1, 1) buffers. `shape` and `device` are the normalized tensor's,
    as the modules see them."""

    frames: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor
    dtype: torch.dtype

    @property
    def shape(self) -> torch.Size:
        b, h, w, c = self.frames.shape
        return torch.Size((b, c, h, w))

    @property
    def device(self) -> torch.device:
        return self.frames.device

    def normalized(self) -> torch.Tensor:
        """The normalized NCHW tensor (channels_last strides); the
        normalization is f32, with a division."""
        x = self.frames.permute(0, 3, 1, 2).float()
        return ((x - self.mean) / self.std).to(self.dtype)


def stem_conv_engages(*, device_type: str, training: bool, grad: bool, foldable: bool, relu: bool,
                      dtype: torch.dtype, groups: int, kernel_size: int, stride: int, in_channels: int,
                      out_channels: int, frames: bool, quantizes: bool, capture: bool) -> bool:
    """Whether a ConvNorm runs through the stem kernel: on CUDA, in eval with
    autograd off (the kernel has no backward), its norm folded, a ReLU after
    it, bf16, one group, one of `STEM_SHAPES` (the 7x7 one on frames, the
    others on tensors), and the conv would run F.conv2d in this call: it
    does not quantize and no calibration captures (the fused stem has no
    normalized tensor to capture)."""
    kind = STEM_SHAPES.get((kernel_size, stride, in_channels, out_channels))
    return (kind is not None and frames == (kind == FRAMES_KIND) and device_type == "cuda" and not training
            and not grad and foldable and relu and dtype == torch.bfloat16 and groups == 1 and not quantizes
            and not capture)


def _check(x, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> int:
    frames = isinstance(x, NormalizedFrames)
    if weight.ndim != 4 or weight.shape[2] != weight.shape[3] or bias.shape != (weight.shape[0],):
        raise ValueError(f"need weight (O, C, k, k) and bias (O,); got {tuple(weight.shape)}, {tuple(bias.shape)}")
    kind = STEM_SHAPES.get((weight.shape[3], stride, x.shape[1], weight.shape[0]))
    if kind is None or weight.shape[1] != x.shape[1] or frames != (kind == FRAMES_KIND):
        raise ValueError(f"the stem conv takes {sorted(STEM_SHAPES)} (k, stride, C, O), the 7x7 one on "
                         f"NormalizedFrames; got weight {tuple(weight.shape)}, stride {stride}, "
                         f"{'frames' if frames else 'a tensor'} of shape {tuple(x.shape)}")
    if weight.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16:
        raise TypeError(f"need a bf16 weight and bias; got {weight.dtype}, {bias.dtype}")
    if frames and (x.dtype != torch.bfloat16 or x.mean.numel() != 3 or x.std.numel() != 3):
        raise TypeError(f"need frames normalized to bf16 by 3 means and stds; got {x.dtype}")
    if not frames and x.dtype != torch.bfloat16:
        raise TypeError(f"need a bf16 input; got {x.dtype}")
    if any(t.device != x.device for t in (weight, bias)):
        raise ValueError("x, weight and bias must be on one device")
    return kind


def stem_conv_plain(x, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain PyTorch version of `stem_conv`, on any device."""
    _check(x, weight, bias, stride)
    if isinstance(x, NormalizedFrames):
        x = x.normalized()
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        y = F.conv2d(x.float(), weight.float(), None, stride, (weight.shape[-1] - 1) // 2)
    return F.relu(y.to(torch.bfloat16) + bias[:, None, None])


_lib = None


def _library():
    global _lib
    if _lib is None:
        from dd3d_tpu_torch.kernels import load_library

        lib = load_library("stem_conv.cu")
        lib.dd3d_stem_conv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.dd3d_stem_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def stem_conv(x, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """relu(conv(x, weight) + bias) NCHW bf16; see the module docstring.
    `stem_conv.launches` counts kernel launches."""
    kind = _check(x, weight, bias, stride)
    if x.device.type == "cpu":
        return stem_conv_plain(x, weight, bias, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no stem conv kernel for device {x.device}")
    if kind == FRAMES_KIND:
        if x.frames.dtype != torch.uint8 or x.mean.device != x.device or x.std.device != x.device:
            raise TypeError(f"the kernel reads uint8 frames with mean and std on their device; got {x.frames.dtype}")
        src = x.frames.contiguous()
        mean, std = x.mean.float().contiguous(), x.std.float().contiguous()
        means = (mean.data_ptr(), std.data_ptr())
    else:
        src = x.permute(0, 2, 3, 1)
        if not src.is_contiguous():
            src = src.contiguous()  # an explicit copy to NHWC; the kernel takes no other layout
        if src.data_ptr() % 16:
            src = src.clone()  # the kernel stages 16-byte chunks
        means = (None, None)
    b, h, w, c = src.shape
    o = weight.shape[0]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty((b, ho, wo, o), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i0, i1 in batch_chunks(b, max(h * w * c, ho * wo * o)):
            err = _library().dd3d_stem_conv(kind, src[i0:i1].data_ptr(), weight.data_ptr(), bias.data_ptr(), *means,
                                            out[i0:i1].data_ptr(), i1 - i0, h, w, stream)
            if err != 0:
                raise RuntimeError(f"stem conv kernel launch failed: cudaError {err}")
            stem_conv.launches += 1
    return out.permute(0, 3, 1, 2)


stem_conv.launches = 0
