"""Class-aware greedy NMS on fixed-size inputs, counterpart of
dd3d_tpu/ops/nms.py.

Inputs are fixed-size with a validity encoding (score == NEG_INF means "no
box") and outputs are fixed-size with a keep mask. `pairwise_iou_xyxy` and
`greedy_suppress` are the plain PyTorch version of the suppression; the
serving path suppresses through the hand-written CUDA kernel
(ops/nms_kernel.py), which computes the same keep mask bit for bit.
"""
import torch

NEG_INF = -1e10


def pairwise_iou_xyxy(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M) IoU, with the
    operation order of dd3d_tpu/ops/nms.py:22-34 (the kernel repeats it)."""
    ax1, ay1, ax2, ay2 = (v[..., :, None] for v in boxes_a.unbind(-1))
    bx1, by1, bx2, by2 = (v[..., None, :] for v in boxes_b.unbind(-1))
    inter_w = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    inter_h = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = inter_w * inter_h
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1, min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1, min=0.0)
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-9)


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS keep mask from a score-sorted IoU matrix.

    iou: (..., N, N) pairwise IoU of boxes in DESCENDING score order;
    valid: (..., N) bool — invalid boxes are never kept and never suppress.
    Fixpoint of alive(i) = valid(i) and no alive j < i with iou(j, i) > T,
    which the greedy walk reaches in at most its longest suppression chain.
    """
    n = iou.shape[-1]
    idx = torch.arange(n, device=iou.device)
    overlap = (iou > iou_threshold) & (idx[:, None] < idx[None, :])  # [j, i]: j would suppress i
    alive = valid
    while True:
        new_alive = valid & ~torch.any(overlap & alive[..., :, None], dim=-2)
        if torch.equal(new_alive, alive):
            return alive
        alive = new_alive


def batched_nms_padded(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                       iou_threshold: float, max_outputs: int, assume_sorted: bool = False,
                       suppress=None):
    """Class-aware NMS over a batch of fixed-size candidate sets.

    boxes: (B, N, 4) xyxy; scores: (B, N) with NEG_INF for padding;
    classes: (B, N) int. Returns (order, keep_sorted), both (B, N): `order`
    indexes the input in descending score order, `keep_sorted` is the keep
    mask in that order with at most `max_outputs` True entries (the top
    kept boxes). `assume_sorted`: the inputs are already score-descending.
    `suppress(boxes, valid, iou_threshold) -> keep` defaults to the CUDA
    kernel's wrapper (ops/nms_kernel.greedy_nms).
    """
    if suppress is None:
        from dd3d_tpu_torch.ops.nms_kernel import greedy_nms as suppress
    b, n = scores.shape
    if assume_sorted:
        order = torch.arange(n, device=scores.device).expand(b, n)
        boxes_s, scores_s, classes_s = boxes, scores, classes
    else:
        # stable: ties keep the lower index first, as jnp.argsort
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
        scores_s = torch.gather(scores, 1, order)
        classes_s = torch.gather(classes, 1, order)
    valid = scores_s > NEG_INF / 2

    # Class-offset trick: shift each class to a disjoint coordinate region so
    # cross-class IoU is exactly 0. The kernel gets the shifted boxes (not a
    # same-class test) so its IoU rounds exactly as the JAX package's.
    span = torch.where(valid[..., None], boxes_s, 0.0).amax(dim=(1, 2)) + 1.0  # (B,)
    shifted = boxes_s + classes_s.to(boxes_s.dtype)[..., None] * span[:, None, None]

    keep = suppress(shifted.contiguous(), valid.contiguous(), iou_threshold)
    if max_outputs is not None and max_outputs > 0:
        kept_rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        keep = keep & (kept_rank < max_outputs)
    return order, keep
