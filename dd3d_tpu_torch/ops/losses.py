"""Loss primitives, counterpart of dd3d_tpu/ops/losses.py: sigmoid focal
loss, BCE with logits, the FCOS IoU family on ltrb distances (trailing and
component-major layouts) and smooth-L1. Elementwise and UNREDUCED; masking
and normalization belong to the model-level losses."""
import torch


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits: max(x, 0) - x*t + log(1 + exp(-|x|))."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element sigmoid focal loss (fvcore semantics); targets in {0, 1}."""
    p = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * ((1.0 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def _iou_loss(pl, pt, pr, pb, tl, tt, tr, tb, loc_loss_type: str) -> torch.Tensor:
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_intersect = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_intersect = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w * g_h
    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect
    ious = (area_intersect + 1.0) / (area_union + 1.0)
    if loc_loss_type == "iou":
        return -torch.log(torch.clamp(ious, min=1e-12))
    if loc_loss_type == "linear_iou":
        return 1.0 - ious
    if loc_loss_type == "giou":
        return 1.0 - (ious - (ac_union - area_union) / torch.clamp(ac_union, min=1e-7))
    raise NotImplementedError(loc_loss_type)


def iou_loss_ltrb(pred: torch.Tensor, target: torch.Tensor, loc_loss_type: str = "giou") -> torch.Tensor:
    """FCOS IoU losses on (..., 4) ltrb distances, with the +1 smoothing of
    the ratio (tridet/layers/iou_loss.py). Returns (...)."""
    return _iou_loss(*pred.unbind(-1), *target.unbind(-1), loc_loss_type)


def iou_loss_ltrb_t(pred: torch.Tensor, target: torch.Tensor, loc_loss_type: str = "giou") -> torch.Tensor:
    """The same on the component-major layout: (B, 4, P) in, (B, P) out."""
    return _iou_loss(*pred.unbind(1), *target.unbind(1), loc_loss_type)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Per-element smooth L1; beta < 1e-5 is plain L1."""
    diff = torch.abs(pred - target)
    if beta < 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
