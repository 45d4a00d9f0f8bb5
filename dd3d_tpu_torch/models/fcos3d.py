"""FCOS3D head, loss, box decode and inference gather, counterpart of
dd3d_tpu/models/fcos3d.py.

- shared box3d conv tower with per-level FrozenBN folded per level + five
  predictors (quat 4C / proj_ctr 2C / depth 1C / size 3C / conf 1C) run as
  one conv, learnable per-level Scale/Offset. With `per_level_predictors`
  each level has its own five (`box3d_quat{l}`, ...), run as that level's
  group; with `class_agnostic` C is 1: one box a location, whatever its
  class (DD3D.FCOS3D.PER_LEVEL_PREDICTORS, CLASS_AGNOSTIC_BOX3D);
- `predictions_to_boxes3d`: camera-aware decode — depth scaled by focal
  length, allocentric->egocentric rotation, tanh size around canonical sizes;
- `fcos3d_loss`: the disentangled 8-corner loss and the 3D confidence BCE
  on component-major maps;
- `decode_fcos3d_candidates`: gathers the 3D outputs at the 2D candidates.
"""
from typing import Dict, List, Sequence

import torch
from torch import nn

from dd3d_tpu_torch.models.layers import Offset, PredictorConv, Scale, TowerConv, fused_predictor_apply, run_tower
from dd3d_tpu_torch.models.loss_geometry import allocentric_to_egocentric_t, corners_t, normalize_rows, unproject_t
from dd3d_tpu_torch.ops.losses import sigmoid_bce, smooth_l1_loss
from dd3d_tpu_torch.ops.geometry import allocentric_to_egocentric, unproject_points2d
from dd3d_tpu_torch.structures.boxes3d import Boxes3D

EPS = 1e-7


class FCOS3DHead(nn.Module):
    """Takes and returns per-level NCHW tensors."""

    def __init__(self, num_classes: int, in_channels: int, in_strides: Sequence[int],
                 mean_depth_per_level: Sequence[float], std_depth_per_level: Sequence[float],
                 num_convs: int = 4, norm: str = "FrozenBN", use_scale: bool = True,
                 depth_scale_init_factor: float = 0.3, proj_ctr_scale_init_factor: float = 1.0,
                 per_level_predictors: bool = False, class_agnostic: bool = False):
        super().__init__()
        num_levels = len(in_strides)
        self.box3d_tower = nn.ModuleList([TowerConv(in_channels, num_levels, norm) for _ in range(num_convs)])
        nc = 1 if class_agnostic else num_classes
        self.per_level_predictors = per_level_predictors
        n_pred = num_levels if per_level_predictors else 1

        def predictors(out_channels, bias=True):
            return nn.ModuleList([PredictorConv(in_channels, out_channels, bias=bias) for _ in range(n_pred)])

        self.box3d_quat = predictors(4 * nc)
        self.box3d_ctr = predictors(2 * nc)
        # the depth predictor has no bias when scales are used
        self.box3d_depth = predictors(1 * nc, bias=not use_scale)
        self.box3d_size = predictors(3 * nc)
        self.box3d_conf = predictors(1 * nc)
        self.use_scale = use_scale
        if use_scale:
            self.scales_proj_ctr = nn.ModuleList(
                [Scale(float(s) * proj_ctr_scale_init_factor) for s in in_strides])
            self.scales_size = nn.ModuleList([Scale(1.0) for _ in in_strides])
            self.scales_conf = nn.ModuleList([Scale(1.0) for _ in in_strides])
            # one per level, from the first entries of the depth statistics:
            # the JAX package creates the modules of every entry but only the
            # levels' get parameters (dd3d_tpu/models/fcos3d.py:109-112)
            self.scales_depth = nn.ModuleList(
                [Scale(float(s) * depth_scale_init_factor) for s in std_depth_per_level[:num_levels]])
            self.offsets_depth = nn.ModuleList([Offset(float(m)) for m in mean_depth_per_level[:num_levels]])
        # reference checkpoints carry these (dataset depth statistics)
        self.register_buffer("mean_depth_per_level", torch.tensor([float(m) for m in mean_depth_per_level]))
        self.register_buffer("std_depth_per_level", torch.tensor([float(s) for s in std_depth_per_level]))

    def forward(self, features: List[torch.Tensor]):
        quat_out, ctr_out, depth_out, size_out, conf_out = [], [], [], [], []
        for l, x in enumerate(features):
            # this level's group, keyed (int8) by its own first sibling
            p = l if self.per_level_predictors else 0
            preds = [self.box3d_quat[p], self.box3d_ctr[p], self.box3d_depth[p], self.box3d_size[p],
                     self.box3d_conf[p]]
            x = run_tower(self.box3d_tower, x, l, preds)
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


def gather_per_class_t(pred_flat: torch.Tensor, onehot_c: torch.Tensor, comp_dim: int, num_classes: int):
    """(B, comp_dim * C, P) -> (B, comp_dim, P): each location's class, as
    the JAX package's exact f32 one-hot multiply-sum (channel order
    [comp, class] row-major)."""
    return torch.stack([torch.sum(pred_flat[:, k * num_classes:(k + 1) * num_classes] * onehot_c, dim=1)
                        for k in range(comp_dim)], dim=1)


def fcos3d_loss(quat_flat: torch.Tensor, ctr_flat: torch.Tensor, depth_flat: torch.Tensor,
                size_flat: torch.Tensor, conf_flat: torch.Tensor, targets: Dict[str, torch.Tensor],
                fcos2d_info: Dict[str, torch.Tensor], inv_intrinsics: torch.Tensor, locations: torch.Tensor,
                canon_box_sizes: torch.Tensor, cfg3d) -> Dict[str, torch.Tensor]:
    """Dense masked FCOS3D loss (dd3d_tpu/models/fcos3d.py:248-358): maps
    (B, comp * C, P) f32, inv_intrinsics (B, 3, 3), locations (P, 2),
    canon_box_sizes (>= C, 3). Normalized by the 2D loss's centerness sum,
    the global batch's (summed over the ranks in `fcos2d_loss`). With
    CLASS_AGNOSTIC_BOX3D the maps hold one box a location (C = 1), read as
    they are; the canonical size is still the true class's (JAX :276-285)."""
    pos_mask = targets["pos_mask"]
    pos = pos_mask.float()
    labels_safe = torch.where(pos_mask, targets["labels"], 0)
    device = conf_flat.device

    canon_tbl = canon_box_sizes.float()
    onehot_canon = (labels_safe[:, None, :] == torch.arange(canon_tbl.shape[0], device=device)[None, :, None]).float()
    if cfg3d.CLASS_AGNOSTIC_BOX3D:
        quat_p, ctr_p, depth_p, size_p, conf_p = quat_flat, ctr_flat, depth_flat[:, 0], size_flat, conf_flat[:, 0]
    else:
        num_classes = conf_flat.shape[1]
        onehot_c = (labels_safe[:, None, :] == torch.arange(num_classes, device=device)[None, :, None]).float()
        quat_p = gather_per_class_t(quat_flat, onehot_c, 4, num_classes)
        ctr_p = gather_per_class_t(ctr_flat, onehot_c, 2, num_classes)
        depth_p = gather_per_class_t(depth_flat, onehot_c, 1, num_classes)[:, 0]
        size_p = gather_per_class_t(size_flat, onehot_c, 3, num_classes)
        conf_p = gather_per_class_t(conf_flat, onehot_c, 1, num_classes)[:, 0]
    canon = torch.stack([torch.sum(onehot_canon * canon_tbl[None, :, j, None], dim=1) for j in range(3)], dim=1)

    # predictions_to_boxes3d, component-major
    quat_p = normalize_rows(quat_p, dim=1)
    depth_d = depth_p
    if cfg3d.SCALE_DEPTH_BY_FOCAL_LENGTHS:
        pixel_size = torch.sqrt(inv_intrinsics[:, 0, 0] ** 2 + inv_intrinsics[:, 1, 1] ** 2)[:, None]
        depth_d = depth_d / (pixel_size * cfg3d.SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR)
    loc_t = locations.t()[None]  # (1, 2, P)
    if cfg3d.PREDICT_DISTANCE:
        ray = unproject_t(loc_t.expand(pos.shape[0], 2, pos.shape[1]), inv_intrinsics)
        depth_d = depth_d / torch.clamp(torch.sqrt(torch.sum(ray * ray, dim=1)), min=EPS)
    depth_d = torch.clamp(depth_d, cfg3d.MIN_DEPTH, cfg3d.MAX_DEPTH)
    ctr_d = ctr_p + loc_t
    quat_d = allocentric_to_egocentric_t(quat_p, ctr_d, inv_intrinsics) if cfg3d.PREDICT_ALLOCENTRIC_ROT else quat_p
    size_d = (torch.tanh(size_p) + 1.0) * canon

    # disentangled 8-corner loss: one predicted component at a time
    box3d = targets["box3d_targets"]
    tq, tc, td, ts = box3d[:, 0:4], box3d[:, 4:6], box3d[:, 6], box3d[:, 7:10]
    target_corners = corners_t(tq, tc, td, ts, inv_intrinsics)
    weights = fcos2d_info["centerness_targets"]
    loss_denom = fcos2d_info["loss_denom"]
    w3d, beta = cfg3d.LOSS.WEIGHT_BOX3D, cfg3d.LOSS.SMOOTH_L1_BETA
    subs = {
        "quat": (quat_d, tc, td, ts),
        "proj_ctr": (tq, ctr_d, td, ts),
        "depth": (tq, tc, depth_d, ts),
        "size": (tq, tc, td, size_d),
    }
    losses = {}
    for key, (q, c, d, sz) in subs.items():
        per_loc = smooth_l1_loss(corners_t(q, c, d, sz, inv_intrinsics), target_corners, beta).mean(dim=1)
        losses[f"loss_box3d_{key}"] = w3d * torch.sum(per_loc * weights * pos) / loss_denom

    with torch.no_grad():
        pred_corners = corners_t(quat_d, ctr_d, depth_d, size_d, inv_intrinsics)
        l1_err = torch.abs(target_corners - pred_corners).mean(dim=1)
        conf_target = torch.exp(-l1_err / cfg3d.LOSS.CONF_3D_TEMPERATURE)
    conf_bce = sigmoid_bce(conf_p, conf_target)
    losses["loss_conf3d"] = cfg3d.LOSS.WEIGHT_CONF3D * torch.sum(conf_bce * weights * pos) / loss_denom
    return losses


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
    class_agnostic: bool = False,
) -> Dict[str, torch.Tensor]:
    """Gather the 3D outputs at the 2D candidates (one row gather over the
    concatenated channels) and decode them to Boxes3D fields; with
    `class_agnostic` the maps hold one box a location, which every class
    reads (JAX :384-406)."""
    b, h, w, _ = conf.shape
    nc = 1 if class_agnostic else num_classes
    k = cand["loc_idx"].shape[1]

    comps = [(quat, 4), (ctr, 2), (depth, 1), (size, 3), (conf, 1)]
    stacked = torch.cat([x.reshape(b, h * w, c * nc) for x, c in comps], dim=-1)
    rows = torch.gather(stacked, 1, cand["loc_idx"][..., None].expand(b, k, stacked.shape[-1])).float()

    # Class selection: a gather returns exactly the value the JAX package's
    # one-hot multiply-sum does.
    cls_index = torch.zeros_like(cand["cls"]) if class_agnostic else cand["cls"]
    cls_index = cls_index[:, :, None, None]
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
