"""ctypes wrappers of the KITTI R40 engine (dd3d_tpu_torch/csrc/kitti_eval.cpp),
the port's counterpart of dd3d_tpu/evaluators/native/__init__.py.

The engine is host C++ with OpenMP, as in the JAX package: rotated BEV IoU,
3D overlap, threshold extraction and the fused TP/FP statistics (the
reference's numba kernels, tridet/evaluators/rotate_iou.py and
kitti_3d_evaluator.py:749-1038). The port builds its own copy of the source
with g++ on first use (dd3d_tpu_torch/kernels); a failed build raises.
"""
import ctypes

import numpy as np

_lib = None


def get_lib() -> ctypes.CDLL:
    """The engine's library, built on first use, with its signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    from dd3d_tpu_torch.kernels import load_library

    lib = load_library("kitti_eval.cpp")
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    lib.rotated_iou_matrix.argtypes = [c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64, ctypes.c_int, c_double_p]
    lib.d3_box_overlap_inplace.argtypes = [c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64, ctypes.c_int,
                                           c_double_p]
    lib.compute_threshold.restype = ctypes.c_int64
    lib.compute_threshold.argtypes = [c_double_p, ctypes.c_int64, ctypes.c_int64, c_double_p, c_int64_p, c_int64_p,
                                      ctypes.c_double, c_double_p]
    lib.fused_compute_statistics.argtypes = [
        c_double_p, c_double_p, ctypes.c_int64, ctypes.c_int64, c_int64_p, c_int64_p, c_double_p, c_double_p,
        c_int64_p, c_int64_p, ctypes.c_double, c_double_p, ctypes.c_int, ctypes.c_int64]
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _check(condition: bool, what: str) -> None:
    """The engine reads raw pointers: a shape that does not match is refused
    here, before any is passed."""
    if not condition:
        raise ValueError(what)


def rotated_iou_matrix(boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1) -> np.ndarray:
    """boxes (N, 5), qboxes (K, 5) [cx, cy, dx, dy, angle] -> (N, K)."""
    boxes, qboxes = _f64(boxes), _f64(qboxes)
    _check(boxes.ndim == qboxes.ndim == 2 and boxes.shape[1] == qboxes.shape[1] == 5,
           f"need (N, 5) and (K, 5) boxes; got {boxes.shape}, {qboxes.shape}")
    n, k = len(boxes), len(qboxes)
    out = np.zeros((n, k), dtype=np.float64)
    if n and k:
        get_lib().rotated_iou_matrix(_dp(boxes), n, _dp(qboxes), k, criterion, _dp(out))
    return out


def d3_box_overlap(boxes7: np.ndarray, qboxes7: np.ndarray, criterion: int = -1) -> np.ndarray:
    """boxes7 (N, 7) [x, y, z, l, h, w, ry] camera frame -> (N, K) 3D IoU
    (box_3d_overlap, kitti_3d_evaluator.py:622-627)."""
    boxes7, qboxes7 = _f64(boxes7), _f64(qboxes7)
    _check(boxes7.ndim == qboxes7.ndim == 2 and boxes7.shape[1] == qboxes7.shape[1] == 7,
           f"need (N, 7) and (K, 7) boxes; got {boxes7.shape}, {qboxes7.shape}")
    rinc = rotated_iou_matrix(boxes7[:, [0, 2, 3, 5, 6]], qboxes7[:, [0, 2, 3, 5, 6]], criterion=2)
    n, k = len(boxes7), len(qboxes7)
    if n and k:
        get_lib().d3_box_overlap_inplace(_dp(boxes7), n, _dp(qboxes7), k, criterion, _dp(rinc))
    return rinc


def compute_threshold(overlaps, dt_scores, ignored_gt, ignored_det, min_overlap) -> np.ndarray:
    """Scores of the detections greedily matched to valid ground truth."""
    overlaps, dt_scores = _f64(overlaps), _f64(dt_scores)
    ignored_gt, ignored_det = _i64(ignored_gt), _i64(ignored_det)
    det_size, gt_size = overlaps.shape
    _check(dt_scores.shape == ignored_det.shape == (det_size,) and ignored_gt.shape == (gt_size,),
           f"overlaps {overlaps.shape} against scores {dt_scores.shape}, ignored {ignored_gt.shape} {ignored_det.shape}")
    out = np.zeros(max(gt_size, 1), dtype=np.float64)
    n = get_lib().compute_threshold(_dp(overlaps), det_size, gt_size, _dp(dt_scores), _ip(ignored_gt),
                                    _ip(ignored_det), float(min_overlap), _dp(out))
    return out[:n]


def fused_compute_statistics(overlaps, pr, gt_nums, dt_nums, gt_datas, dt_datas, ignored_gts, ignored_dets,
                             min_overlap, thresholds, compute_angular=True) -> None:
    """Accumulate tp/fp/fn/... into `pr` (T, 8) f64 over a shard of images."""
    overlaps, gt_datas, dt_datas, thresholds = _f64(overlaps), _f64(gt_datas), _f64(dt_datas), _f64(thresholds)
    gt_nums, dt_nums = _i64(gt_nums), _i64(dt_nums)
    ignored_gts, ignored_dets = _i64(ignored_gts), _i64(ignored_dets)
    if pr.dtype != np.float64 or not pr.flags.c_contiguous:
        raise ValueError("pr must be a C-contiguous float64 array")
    total_gt, total_dt = int(gt_nums.sum()), int(dt_nums.sum())
    _check(gt_nums.shape == dt_nums.shape and overlaps.shape == (total_dt, total_gt)
           and gt_datas.shape == (total_gt, 9) and dt_datas.shape == (total_dt, 10)
           and ignored_gts.shape == (total_gt,) and ignored_dets.shape == (total_dt,)
           and pr.shape == (len(thresholds), 8),
           f"shapes do not match {total_dt} detections and {total_gt} ground-truth boxes: overlaps {overlaps.shape}, "
           f"data {gt_datas.shape} {dt_datas.shape}, ignored {ignored_gts.shape} {ignored_dets.shape}, pr {pr.shape}")
    get_lib().fused_compute_statistics(
        _dp(overlaps), _dp(pr), len(gt_nums), len(thresholds), _ip(gt_nums), _ip(dt_nums), _dp(gt_datas),
        _dp(dt_datas), _ip(ignored_gts), _ip(ignored_dets), float(min_overlap), _dp(thresholds),
        int(compute_angular), total_gt)
