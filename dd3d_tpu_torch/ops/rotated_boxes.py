"""Rotated-rectangle IoU and BEV NMS on fixed-size tensors, counterpart of
dd3d_tpu/ops/rotated_boxes.py.

Geometry follows the reference's BEV conventions (tridet/layers/bev_nms.py):
camera -> vehicle -> BEV axis swaps, and the top-face corners [0, 1, 5, 4] of
a 3D box -> a 5-parameter rotated box (cx, cy, width, length, angle in
degrees). The intersection of two convex quads is a fixed-size
Sutherland-Hodgman clip (8 vertex slots and a count of the valid ones),
batched over every pair at once: no Python loop over boxes. The arithmetic
of the clip is JAX's, in the same order, so f32 IoUs agree to rounding.

`rotated_nms_padded` suppresses through `suppress(iou, valid, threshold)`,
by default the CUDA scan's wrapper (ops/nms_kernel.greedy_nms_scan), which
runs the plain `greedy_suppress` on CPU tensors. Under a profiler it opens
the spans `bev.iou` (the sort, the gathers, the IoU and its class mask)
and `bev.scan` (the suppression), under whichever span its caller holds.
"""
import math

import torch

from dd3d_tpu_torch.ops.nms import NEG_INF
from dd3d_tpu_torch.ops.quaternion import matvec3
from dd3d_tpu_torch.utils.profiling import annotate

# Rotation camera -> vehicle (z->x fwd, x->-y right, y->-z down), then
# vehicle -> BEV (bev_nms.py:27-47).
CAMERA_TO_VEHICLE = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
VEHICLE_TO_BEV = ((0.0, -1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, -1.0))
CAMERA_TO_BEV = tuple(tuple(sum(VEHICLE_TO_BEV[i][k] * CAMERA_TO_VEHICLE[k][j] for k in range(3)) for j in range(3))
                      for i in range(3))
TOP_FACE = (0, 1, 5, 4)  # bev_nms.py:72


def corners_to_rotated_box(top_corners_bev: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) top-face corners (front-left, front-right, back-right,
    back-left) -> (..., 5) [cx, cy, w, l, angle_deg]."""
    fl, fr, br, bl = top_corners_bev.unbind(-2)
    length = torch.linalg.norm(fl - bl, dim=-1)
    width = torch.linalg.norm(fl - fr, dim=-1)
    center = (fl + br) / 2.0
    forward = fl - bl
    angle = torch.atan2(forward[..., 0], forward[..., 1]) * 180.0 / math.pi
    return torch.stack([center[..., 0], center[..., 1], width, length, angle], dim=-1)


def top_face_bev(corners: torch.Tensor, to_bev) -> torch.Tensor:
    """(..., 8, 3) corners -> (..., 4, 2) top-face corners rotated by the
    3x3 `to_bev` (nested tuples) and projected on the BEV plane."""
    rot = torch.tensor(to_bev, dtype=torch.float32, device=corners.device)
    return matvec3(rot, corners[..., list(TOP_FACE), :])[..., :2]


def boxes3d_corners_to_bev_boxes(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) camera-frame box corners -> (..., 5) BEV rotated boxes."""
    return corners_to_rotated_box(top_face_bev(corners, CAMERA_TO_BEV))


def _rotated_corners(box5: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corners, CCW in standard axes. The angle turns
    clockwise ([[c, s], [-s, c]]), as the reference's CUDA kernel and the
    atan2(forward_x, forward_y) heading of `corners_to_rotated_box`."""
    ang = box5[..., 4] * math.pi / 180.0
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    hx, hy = box5[..., 2] / 2, box5[..., 3] / 2
    lx = torch.stack([hx, -hx, -hx, hx], dim=-1)
    ly = torch.stack([hy, hy, -hy, -hy], dim=-1)
    x = c * lx + s * ly + box5[..., 0:1]
    y = -s * lx + c * ly + box5[..., 1:2]
    return torch.stack([x, y], dim=-1)


def _clip_halfplane(poly: torch.Tensor, nv: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Clip polygons (..., V, 2) with `nv` (...) valid CCW vertices by the
    left half-plane of the edges a -> b (..., 2); the survivors move to the
    front (stable), at most V of them."""
    v = poly.shape[-2]
    i = torch.arange(v, device=poly.device)
    nxt_idx = torch.where(i + 1 >= nv[..., None], 0, i + 1)
    cur = poly
    nxt = torch.gather(poly, -2, nxt_idx[..., None].expand(poly.shape))
    e = b - a
    ex, ey = e[..., 0:1], e[..., 1:2]
    ax, ay = a[..., 0:1], a[..., 1:2]
    d_cur = ex * (cur[..., 1] - ay) - ey * (cur[..., 0] - ax)
    d_nxt = ex * (nxt[..., 1] - ay) - ey * (nxt[..., 0] - ax)
    valid_in = i < nv[..., None]
    in_cur = d_cur >= 0
    in_nxt = d_nxt >= 0
    denom = d_cur - d_nxt
    t = d_cur / torch.where(denom.abs() < 1e-12, torch.where(denom < 0, -1e-12, 1e-12), denom)
    inter = cur + t[..., None] * (nxt - cur)

    # interleaved [cur_0, inter_0, cur_1, inter_1, ...]
    emit = torch.stack([cur, inter], dim=-2).flatten(-3, -2)
    valid = torch.stack([in_cur & valid_in, (in_cur != in_nxt) & valid_in], dim=-1).flatten(-2)
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices[..., :v]
    emit = torch.gather(emit, -2, order[..., None].expand(order.shape + (2,)))
    new_nv = torch.clamp(valid.sum(-1), max=v)
    return emit, new_nv


def _poly_area(poly: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    v = poly.shape[-2]
    i = torch.arange(v, device=poly.device)
    nxt_idx = torch.where(i + 1 >= nv[..., None], 0, i + 1)
    nxt = torch.gather(poly, -2, nxt_idx[..., None].expand(poly.shape))
    terms = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    terms = torch.where(i < nv[..., None], terms, 0.0)
    return terms.sum(-1).abs() / 2.0


def _intersection_area(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex quads ca (..., 4, 2) and cb (..., 4, 2)
    (broadcast against each other), CCW corners."""
    shape = torch.broadcast_shapes(ca.shape[:-2], cb.shape[:-2])
    poly = torch.cat([ca.expand(shape + (4, 2)), ca.new_zeros(shape + (4, 2))], dim=-2)
    nv = torch.full(shape, 4, dtype=torch.int64, device=ca.device)
    cb = cb.expand(shape + (4, 2))
    for e in range(4):
        poly, nv = _clip_halfplane(poly, nv, cb[..., e, :], cb[..., (e + 1) % 4, :])
    return torch.where(nv >= 3, _poly_area(poly, nv), 0.0)


def pairwise_rotated_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., M, 5) rotated boxes -> (..., N, M) IoU matrix, f32.
    Each pair is clipped about the midpoint of its two centres, as
    detectron2's box_iou_rotated shifts it: in a global frame hundreds of
    metres from the origin, the area's sum of products of absolute
    coordinates would lose a small box's overlap to f32 rounding (IoU off by
    up to 0.16 at 300 m)."""
    boxes_a, boxes_b = boxes_a.float(), boxes_b.float()
    half = (boxes_a[..., :, None, :2] - boxes_b[..., None, :, :2]) / 2  # (..., N, M, 2)
    local_a = torch.cat([torch.zeros_like(boxes_a[..., :2]), boxes_a[..., 2:]], dim=-1)
    local_b = torch.cat([torch.zeros_like(boxes_b[..., :2]), boxes_b[..., 2:]], dim=-1)
    ca = _rotated_corners(local_a)[..., :, None, :, :] + half[..., None, :]  # (..., N, M, 4, 2)
    cb = _rotated_corners(local_b)[..., None, :, :, :] - half[..., None, :]
    inter = _intersection_area(ca, cb)
    area_a = boxes_a[..., 2] * boxes_a[..., 3]
    area_b = boxes_b[..., 2] * boxes_b[..., 3]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def rotated_nms_padded(boxes5: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou_threshold: float,
                       max_outputs: int = 0, suppress=None):
    """Class-aware rotated NMS on fixed-size inputs, batched: boxes5 (B, N, 5),
    scores (B, N) with NEG_INF for padding, classes (B, N). Returns (order,
    keep_sorted), both (B, N): the stable descending score order (ties and
    pads keep their index order, as jnp.argsort) and the keep mask in that
    order, with at most `max_outputs` kept when it is > 0. `suppress(iou,
    valid, threshold) -> keep` defaults to the CUDA scan's wrapper."""
    if suppress is None:
        from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_scan as suppress
    with annotate("bev.iou"):
        order = torch.argsort(-scores, dim=-1, stable=True)
        boxes_s = torch.gather(boxes5, 1, order[..., None].expand(boxes5.shape))
        scores_s = torch.gather(scores, 1, order)
        classes_s = torch.gather(classes, 1, order)
        valid = scores_s > NEG_INF / 2
        iou = pairwise_rotated_iou(boxes_s, boxes_s)
        iou = torch.where(classes_s[..., :, None] == classes_s[..., None, :], iou, 0.0)
    with annotate("bev.scan"):
        keep = suppress(iou.contiguous(), valid.contiguous(), iou_threshold)
    if max_outputs and max_outputs > 0:
        kept_rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
        keep = keep & (kept_rank < max_outputs)
    return order, keep
