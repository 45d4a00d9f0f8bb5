"""FCOS target assignment over padded GT, counterpart of
dd3d_tpu/models/prepare_targets.py: one masked (B, G, P) computation, P the
feature locations of all levels and G = TPU.MAX_GT_PER_IMAGE. Centre
sampling with radius x stride clamped to the box, size-of-interest gating
on max(l, t, r, b), the smallest area wins with the first GT on ties, and an
unmatched location gets label == num_classes.

GT 3D boxes are 10-vectors in the decode parameterization
[quat(4, wxyz), proj_ctr(2), depth(1), size(3, wlh)].
"""
from typing import Dict, Sequence, Tuple

import torch

from dd3d_tpu_torch.ops.locations import compute_feature_locations

INF = 1e8


def build_location_bases(feature_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                         sizes_of_interest: Sequence[int], offset: str = "none", device=None):
    """Per-location metadata: locations (P, 2), strides (P,), size ranges
    (P, 2), level ids (P,)."""
    locs, strs, ranges, lvls = [], [], [], []
    edges = [-1] + list(sizes_of_interest) + [INF]
    for l, ((h, w), s) in enumerate(zip(feature_shapes, strides)):
        n = h * w
        locs.append(compute_feature_locations(h, w, s, offset, device=device))
        strs.append(torch.full((n,), float(s), device=device))
        ranges.append(torch.tensor([edges[l], edges[l + 1]], dtype=torch.float32, device=device).expand(n, 2))
        lvls.append(torch.full((n,), l, dtype=torch.int32, device=device))
    return torch.cat(locs), torch.cat(strs), torch.cat(ranges), torch.cat(lvls)


def prepare_targets(locations: torch.Tensor, loc_strides: torch.Tensor, loc_size_ranges: torch.Tensor,
                    gt_boxes2d: torch.Tensor, gt_classes: torch.Tensor, gt_boxes3d: torch.Tensor,
                    gt_valid: torch.Tensor, num_classes: int, center_sample: bool = True,
                    pos_radius: float = 1.5) -> Dict[str, torch.Tensor]:
    """locations (P, 2), loc_strides (P,), loc_size_ranges (P, 2); GT
    boxes2d (B, G, 4) xyxy, classes (B, G), boxes3d (B, G, 10), valid (B, G).
    Returns labels (B, P), box2d_reg_targets (B, 4, P), box3d_targets
    (B, 10, P), pos_mask (B, P), target_inds (B, P) (-1 where negative)."""
    xs = locations[:, 0][None, None, :]  # (1, 1, P)
    ys = locations[:, 1][None, None, :]
    x1, y1, x2, y2 = (gt_boxes2d[..., i][:, :, None] for i in range(4))  # (B, G, 1)

    l = xs - x1  # (B, G, P)
    t = ys - y1
    r = x2 - xs
    b = y2 - ys

    if center_sample:
        cx = (x1 + x2) * 0.5
        cy = (y1 + y2) * 0.5
        rad = (loc_strides * pos_radius)[None, None, :]
        gx1 = torch.maximum(cx - rad, x1)
        gy1 = torch.maximum(cy - rad, y1)
        gx2 = torch.minimum(cx + rad, x2)
        gy2 = torch.minimum(cy + rad, y2)
        inside = (xs - gx1 > 0) & (gy2 - ys > 0) & (gx2 - xs > 0) & (ys - gy1 > 0)
    else:
        inside = torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > 0

    max_ltrb = torch.maximum(torch.maximum(l, t), torch.maximum(r, b))
    cared = (max_ltrb >= loc_size_ranges[None, None, :, 0]) & (max_ltrb <= loc_size_ranges[None, None, :, 1])

    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)  # (B, G, 1)
    cost = torch.where(inside & cared & gt_valid[:, :, None], area, INF)  # (B, G, P)

    min_area = cost.min(dim=1).values  # (B, P)
    # the FIRST GT of least area, as jnp.argmin: written out, not left to
    # torch.argmin's tie order
    num_gt = gt_valid.shape[1]
    iota_g = torch.arange(num_gt, device=cost.device)[None, :, None]
    matched = torch.where(cost == min_area[:, None, :], iota_g, num_gt).min(dim=1).values
    pos_mask = min_area < INF

    onehot_g = (matched[:, None, :] == iota_g).float()  # (B, G, P)
    labels = torch.sum(onehot_g * gt_classes.float()[:, :, None], dim=1).to(torch.int32)
    labels = torch.where(pos_mask, labels, num_classes)

    def select(comp):  # (B, G, P) -> (B, P), the matched GT's value
        return torch.sum(onehot_g * comp, dim=1)

    box2d_reg = torch.stack([select(l), select(t), select(r), select(b)], dim=1)
    box2d_reg = torch.where(pos_mask[:, None, :], box2d_reg, 0.0)
    box3d = torch.stack([select(gt_boxes3d[:, :, k][:, :, None]) for k in range(gt_boxes3d.shape[-1])], dim=1)
    # neutral padding for negatives: an identity quat keeps the corner math finite
    neutral = torch.tensor([1.0, 0, 0, 0, 0, 0, 1.0, 1.0, 1.0, 1.0], device=box3d.device)
    box3d = torch.where(pos_mask[:, None, :], box3d, neutral[None, :, None])
    return {
        "labels": labels.to(torch.int32),
        "box2d_reg_targets": box2d_reg,
        "box3d_targets": box3d,
        "pos_mask": pos_mask,
        "target_inds": torch.where(pos_mask, matched, -1),
    }
