"""FCOS3D head, box decode and inference gather, counterpart of
dd3d_tpu/models/fcos3d.py (inference; the loss belongs to the training
slice).

- shared box3d conv tower with per-level FrozenBN folded per level + five
  predictors (quat 4C / proj_ctr 2C / depth 1C / size 3C / conf 1C) run as
  one conv, learnable per-level Scale/Offset;
- `predictions_to_boxes3d`: camera-aware decode — depth scaled by focal
  length, allocentric->egocentric rotation, tanh size around canonical sizes;
- `decode_fcos3d_candidates`: gathers the 3D outputs at the 2D candidates.
"""
from typing import Dict, List, Sequence

import torch
from torch import nn

from dd3d_tpu_torch.models.layers import Offset, PredictorConv, Scale, TowerConv, fused_predictor_apply
from dd3d_tpu_torch.ops.geometry import allocentric_to_egocentric, unproject_points2d
from dd3d_tpu_torch.structures.boxes3d import Boxes3D

EPS = 1e-7


class FCOS3DHead(nn.Module):
    """Takes and returns per-level NCHW tensors."""

    def __init__(self, num_classes: int, in_channels: int, in_strides: Sequence[int],
                 mean_depth_per_level: Sequence[float], std_depth_per_level: Sequence[float],
                 num_convs: int = 4, norm: str = "FrozenBN", use_scale: bool = True,
                 depth_scale_init_factor: float = 0.3, proj_ctr_scale_init_factor: float = 1.0):
        super().__init__()
        num_levels = len(in_strides)
        self.box3d_tower = nn.ModuleList([TowerConv(in_channels, num_levels, norm) for _ in range(num_convs)])
        nc = num_classes
        self.box3d_quat = nn.ModuleList([PredictorConv(in_channels, 4 * nc)])
        self.box3d_ctr = nn.ModuleList([PredictorConv(in_channels, 2 * nc)])
        # the depth predictor has no bias when scales are used
        self.box3d_depth = nn.ModuleList([PredictorConv(in_channels, 1 * nc, bias=not use_scale)])
        self.box3d_size = nn.ModuleList([PredictorConv(in_channels, 3 * nc)])
        self.box3d_conf = nn.ModuleList([PredictorConv(in_channels, 1 * nc)])
        self.use_scale = use_scale
        if use_scale:
            self.scales_proj_ctr = nn.ModuleList(
                [Scale(float(s) * proj_ctr_scale_init_factor) for s in in_strides])
            self.scales_size = nn.ModuleList([Scale(1.0) for _ in in_strides])
            self.scales_conf = nn.ModuleList([Scale(1.0) for _ in in_strides])
            self.scales_depth = nn.ModuleList(
                [Scale(float(s) * depth_scale_init_factor) for s in std_depth_per_level])
            self.offsets_depth = nn.ModuleList([Offset(float(m)) for m in mean_depth_per_level])
        # reference checkpoints carry these (dataset depth statistics)
        self.register_buffer("mean_depth_per_level", torch.tensor([float(m) for m in mean_depth_per_level]))
        self.register_buffer("std_depth_per_level", torch.tensor([float(s) for s in std_depth_per_level]))

    def forward(self, features: List[torch.Tensor]):
        quat_out, ctr_out, depth_out, size_out, conf_out = [], [], [], [], []
        preds = [self.box3d_quat[0], self.box3d_ctr[0], self.box3d_depth[0], self.box3d_size[0], self.box3d_conf[0]]
        for l, x in enumerate(features):
            for conv in self.box3d_tower:
                x = conv(x, l)
            quat, ctr, depth, size3d, conf3d = fused_predictor_apply(x, preds)
            if self.use_scale:
                ctr = self.scales_proj_ctr[l](ctr)
                size3d = self.scales_size[l](size3d)
                conf3d = self.scales_conf[l](conf3d)
                depth = self.offsets_depth[l](self.scales_depth[l](depth))
            quat_out.append(quat)
            ctr_out.append(ctr)
            depth_out.append(depth)
            size_out.append(size3d)
            conf_out.append(conf3d)
        return quat_out, ctr_out, depth_out, size_out, conf_out


def predictions_to_boxes3d(
    quat: torch.Tensor,  # (..., 4)
    proj_ctr: torch.Tensor,  # (..., 2) offsets
    depth: torch.Tensor,  # (...,)
    size: torch.Tensor,  # (..., 3)
    locations: torch.Tensor,  # (..., 2)
    inv_intrinsics: torch.Tensor,  # (..., 3, 3)
    canon_box_sizes: torch.Tensor,  # (..., 3)
    min_depth: float,
    max_depth: float,
    scale_depth_by_focal_lengths_factor: float = 500.0,
    scale_depth_by_focal_lengths: bool = True,
    quat_is_allocentric: bool = True,
    depth_is_distance: bool = False,
) -> Boxes3D:
    """Decode raw head outputs into camera-frame 3D boxes, in fp32."""
    quat, proj_ctr, depth, size = quat.float(), proj_ctr.float(), depth.float(), size.float()

    # normalized twice, as the JAX package does
    quat = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=EPS)
    quat = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=EPS)

    if scale_depth_by_focal_lengths:
        # pixel_size = ||(1/fx, 1/fy)||; depth /= pixel_size * factor
        pixel_size = torch.sqrt(inv_intrinsics[..., 0, 0] ** 2 + inv_intrinsics[..., 1, 1] ** 2)
        depth = depth / torch.clamp(pixel_size * scale_depth_by_focal_lengths_factor, min=EPS)

    if depth_is_distance:
        ray_norm = torch.linalg.norm(unproject_points2d(locations, inv_intrinsics), dim=-1)
        depth = depth / torch.clamp(ray_norm, min=EPS)

    depth = torch.clamp(depth, min_depth, max_depth)[..., None]
    proj_ctr = proj_ctr + locations
    if quat_is_allocentric:
        quat = allocentric_to_egocentric(quat, proj_ctr, inv_intrinsics)
    size = (torch.tanh(size) + 1.0) * canon_box_sizes  # max size = 2x canonical
    return Boxes3D(quat, proj_ctr, depth, size, inv_intrinsics)


def decode_fcos3d_candidates(
    quat: torch.Tensor,  # (B, H, W, 4C)
    ctr: torch.Tensor,  # (B, H, W, 2C)
    depth: torch.Tensor,  # (B, H, W, C)
    size: torch.Tensor,  # (B, H, W, 3C)
    conf: torch.Tensor,  # (B, H, W, C)
    cand: Dict[str, torch.Tensor],  # output of decode_fcos2d_level
    inv_intrinsics: torch.Tensor,  # (B, 3, 3)
    canon_box_sizes: torch.Tensor,  # (>= num_classes, 3)
    cfg3d,
    num_classes: int,
) -> Dict[str, torch.Tensor]:
    """Gather the 3D outputs at the 2D candidates (one row gather over the
    concatenated channels) and decode them to Boxes3D fields."""
    b, h, w, _ = conf.shape
    nc = num_classes
    k = cand["loc_idx"].shape[1]

    comps = [(quat, 4), (ctr, 2), (depth, 1), (size, 3), (conf, 1)]
    stacked = torch.cat([x.reshape(b, h * w, c * nc) for x, c in comps], dim=-1)
    rows = torch.gather(stacked, 1, cand["loc_idx"][..., None].expand(b, k, stacked.shape[-1])).float()

    # Class selection: a gather returns exactly the value the JAX package's
    # one-hot multiply-sum does.
    cls_index = cand["cls"][:, :, None, None]
    parts, off = [], 0
    for _, c in comps:
        part = rows[..., off: off + c * nc].reshape(b, k, c, nc)
        parts.append(torch.gather(part, -1, cls_index.expand(b, k, c, 1))[..., 0])
        off += c * nc
    quat_k, ctr_k, depth_k, size_k, conf_k = parts
    depth_k = depth_k[..., 0]
    conf_k = torch.sigmoid(conf_k[..., 0])

    cls_safe = torch.where(cand["valid"], cand["cls"], 0)
    canon = canon_box_sizes[cls_safe]  # (B, K, 3)
    inv_k = inv_intrinsics[:, None].expand(b, k, 3, 3)

    boxes3d = predictions_to_boxes3d(
        quat_k, ctr_k, depth_k, size_k, cand["locations"], inv_k, canon,
        cfg3d.MIN_DEPTH, cfg3d.MAX_DEPTH,
        scale_depth_by_focal_lengths_factor=cfg3d.SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR,
        scale_depth_by_focal_lengths=cfg3d.SCALE_DEPTH_BY_FOCAL_LENGTHS,
        quat_is_allocentric=cfg3d.PREDICT_ALLOCENTRIC_ROT,
        depth_is_distance=cfg3d.PREDICT_DISTANCE,
    )
    # scores_3d = 2D score x 3D confidence
    scores_3d = torch.where(cand["valid"], torch.clamp(cand["score"], min=0.0) * conf_k, cand["score"])
    return {
        "boxes3d_quat": boxes3d.quat,
        "boxes3d_proj_ctr": boxes3d.proj_ctr,
        "boxes3d_depth": boxes3d.depth,
        "boxes3d_size": boxes3d.size,
        "conf3d": conf_k,
        "score_3d": scores_3d,
    }
