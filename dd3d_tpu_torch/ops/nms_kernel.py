"""Greedy NMS suppression through the hand-written CUDA kernel
(dd3d_tpu_torch/csrc/nms.cu), the port of dd3d_tpu/ops/pallas_nms.py.

`greedy_nms` takes score-sorted, class-offset boxes (B, N, 4) f32 and valid
(B, N) bool, and returns the keep mask (B, N) bool:
- for CUDA tensors it launches the kernels (or raises: there is no
  fallback): the suppression-bitmask kernel into a (B, N, ceil(N/64)) int64
  scratch from `torch.empty`, then the scan kernel, one warp an image;
- for CPU tensors it runs the plain PyTorch version, `greedy_nms_plain`,
  which the CPU tests and chip_smoke.py hold the kernel against.

`greedy_nms_scan` is the same greedy walk on a suppression matrix the caller
computed, (B, N, N) f32 in descending score order (the rotated BEV NMS's
class-masked IoU): on CUDA tensors the pack kernel turns it into the
bitmask and the scan kernel walks it; on CPU tensors the plain version is
`greedy_suppress` itself.
"""
import ctypes

import torch

from dd3d_tpu_torch.ops.nms import greedy_suppress, pairwise_iou_xyxy


def greedy_nms_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The plain PyTorch version: IoU matrix + greedy fixpoint."""
    return greedy_suppress(pairwise_iou_xyxy(boxes, boxes), valid, iou_threshold)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from dd3d_tpu_torch.kernels import load_library

        lib = load_library("nms.cu")
        lib.dd3d_nms_max_n.argtypes = []
        lib.dd3d_nms_max_n.restype = ctypes.c_int
        lib.dd3d_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.dd3d_nms_keep.restype = ctypes.c_int
        lib.dd3d_nms_pack_mask.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
        lib.dd3d_nms_pack_mask.restype = ctypes.c_int
        lib.dd3d_nms_scan_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
        lib.dd3d_nms_scan_keep.restype = ctypes.c_int
        _lib = lib
    return _lib


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask (B, N) of exact greedy NMS; see the module docstring.
    `greedy_nms.launches` counts the calls that launched the kernels: one a
    call, though a call launches two kernels (mask, then scan)."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"need boxes (B, N, 4) and valid (B, N); got {tuple(boxes.shape)}, {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid; got {boxes.dtype}, {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if boxes.device.type == "cpu":
        return greedy_nms_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    b, n = valid.shape
    lib = _library()
    if n > lib.dd3d_nms_max_n():
        raise ValueError(f"N={n} exceeds the kernel's maximum {lib.dd3d_nms_max_n()}")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    mask = torch.empty((b, n, -(-n // 64)), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.dd3d_nms_keep(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(), b, n,
                                float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0


def greedy_nms_scan(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask (B, N) of exact greedy NMS from a score-sorted suppression
    matrix iou (B, N, N) f32 and valid (B, N) bool: box i suppresses a later
    j when i is kept and iou[i, j] > threshold. CPU tensors run
    `greedy_suppress`; CUDA tensors launch the pack and scan kernels (or
    raise). `greedy_nms_scan.launches` counts the calls that launched them,
    one a call."""
    if iou.ndim != 3 or iou.shape[1] != iou.shape[2] or valid.shape != iou.shape[:2]:
        raise ValueError(f"need iou (B, N, N) and valid (B, N); got {tuple(iou.shape)}, {tuple(valid.shape)}")
    if iou.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 iou and bool valid; got {iou.dtype}, {valid.dtype}")
    if iou.device != valid.device:
        raise ValueError(f"iou on {iou.device}, valid on {valid.device}")
    if iou.device.type == "cpu":
        return greedy_suppress(iou, valid, iou_threshold)
    if iou.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {iou.device}")
    if not (iou.is_contiguous() and valid.is_contiguous()):
        raise ValueError("iou and valid must be contiguous")
    b, n = valid.shape
    lib = _library()
    if n > lib.dd3d_nms_max_n():
        raise ValueError(f"N={n} exceeds the kernel's maximum {lib.dd3d_nms_max_n()}")
    keep = torch.empty((b, n), dtype=torch.bool, device=iou.device)
    mask = torch.empty((b, n, -(-n // 64)), dtype=torch.int64, device=iou.device)
    with torch.cuda.device(iou.device):
        stream = torch.cuda.current_stream(iou.device).cuda_stream
        err = lib.dd3d_nms_pack_mask(iou.data_ptr(), mask.data_ptr(), b, n, float(iou_threshold), stream)
        if err == 0:
            err = lib.dd3d_nms_scan_keep(mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, n, stream)
    if err != 0:
        raise RuntimeError(f"NMS scan kernel launch failed: cudaError {err}")
    greedy_nms_scan.launches += 1
    return keep


greedy_nms_scan.launches = 0
