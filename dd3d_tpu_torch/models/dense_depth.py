"""DD3DDenseDepth, the depth-pretraining meta-architecture, counterpart of
dd3d_tpu/models/dense_depth.py (the reference's
tridet/modeling/dd3d/dense_depth.py and dense_depth_loss.py).

Backbone features -> a shared conv tower `box3d_tower` with per-level norms
-> a 1-channel depth map per level (`dense_depth{l}`, then Scale(std *
DEPTH_SCALE_INIT_FACTOR) and Offset(mean) under USE_SCALE), upsampled to
full resolution by `aligned_bilinear` in f32 and divided by pixel_size *
SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR from the inverse intrinsics; trained
with a masked smooth-L1 against sparse GT depth, each level's loss decayed
by sqrt(2)^level. The reference has no inference for it, nor does the JAX
package; so it has no int8 path (its tower convs are flax nn.Convs there:
`PlainConv`, the norm applied after the conv in the activation dtype, as
JAX's PerLevelNorms does). TPU.PACKED_HEADS(_TRAIN) is accepted and runs
the per-level path, whose outputs the packed one equals.
"""
import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from dd3d_tpu_torch.models import build_feature_extractor, register_meta_arch
from dd3d_tpu_torch.models.layers import INIT_NORMAL_FAN_OUT, Offset, PerLevelNorms, PlainConv, PredictorConv, Scale
from dd3d_tpu_torch.ops.locations import aligned_bilinear
from dd3d_tpu_torch.ops.losses import smooth_l1_loss
from dd3d_tpu_torch.utils.comm import all_reduce_sum
from dd3d_tpu_torch.utils.convert_checkpoint import assign_quant_paths


class NormAfterConv(PlainConv):
    """A tower layer: the shared 3x3 conv (no bias), then the level's norm on
    its output, then relu. Reference names `box3d_tower.<i>.weight`,
    `box3d_tower.<i>.norm.<level>.*`."""

    def __init__(self, channels: int, num_levels: int, norm: str):
        super().__init__(channels, channels, 3, init=INIT_NORMAL_FAN_OUT)
        self.norm = PerLevelNorms(num_levels, channels, norm)

    def forward(self, x, level: int):
        return torch.relu(self.norm(super().forward(x), level))


class DenseDepthHead(nn.Module):
    """cf. DD3DDenseDepthHead (dense_depth.py:17-104); returns per-level
    (B, 1, H, W) depth maps in the activation dtype."""

    def __init__(self, in_channels: int, num_levels: int, mean_depth_per_level: Sequence[float],
                 std_depth_per_level: Sequence[float], num_convs: int = 4, norm: str = "FrozenBN",
                 use_scale: bool = True, depth_scale_init_factor: float = 0.3):
        super().__init__()
        self.use_scale = use_scale
        self.box3d_tower = nn.ModuleList([NormAfterConv(in_channels, num_levels, norm) for _ in range(num_convs)])
        self.dense_depth = nn.ModuleList([PredictorConv(in_channels, 1, bias=not use_scale)
                                          for _ in range(num_levels)])
        if use_scale:
            self.scales_depth = nn.ModuleList([Scale(float(std_depth_per_level[l]) * depth_scale_init_factor)
                                               for l in range(num_levels)])
            self.offsets_depth = nn.ModuleList([Offset(float(mean_depth_per_level[l])) for l in range(num_levels)])

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for l, x in enumerate(features):
            for conv in self.box3d_tower:
                x = conv(x, l)
            d = self.dense_depth[l](x)
            if self.use_scale:
                d = self.offsets_depth[l](self.scales_depth[l](d))
            out.append(d)
        return out


class DD3DDenseDepth(nn.Module):
    """cf. DD3DDenseDepth (dense_depth.py:107-173). `forward(images,
    inv_intrinsics)` takes (B, H, W, 3) BGR images, as DD3D does, and returns
    per-level (B, H, W) f32 depth at full resolution."""

    def __init__(self, backbone: nn.Module, strides: Sequence[int], pixel_mean, pixel_std, head: DenseDepthHead,
                 dtype: torch.dtype, scale_depth_by_focal_lengths: bool = True,
                 scale_depth_by_focal_lengths_factor: float = 500.0, locations_offset: str = "none"):
        super().__init__()
        self.backbone = backbone
        self.strides = tuple(strides)
        self.fcos3d_head = head
        self.dtype = dtype
        self.scale_depth_by_focal_lengths = scale_depth_by_focal_lengths
        self.focal_factor = scale_depth_by_focal_lengths_factor
        self.locations_offset = locations_offset
        self.register_buffer("pixel_mean", torch.tensor(list(pixel_mean), dtype=torch.float32).view(1, 3, 1, 1))
        self.register_buffer("pixel_std", torch.tensor(list(pixel_std), dtype=torch.float32).view(1, 3, 1, 1))

    def forward(self, images: torch.Tensor, inv_intrinsics: torch.Tensor = None) -> List[torch.Tensor]:
        x = ((images.permute(0, 3, 1, 2).float() - self.pixel_mean) / self.pixel_std).to(self.dtype)
        feats = self.backbone(x)
        features = [feats[k] for k in sorted(feats, key=lambda k: int(k[1:]))]
        depth = [aligned_bilinear(d.float(), s, self.locations_offset)[:, 0]
                 for d, s in zip(self.fcos3d_head(features), self.strides)]
        if self.scale_depth_by_focal_lengths and inv_intrinsics is not None:
            pixel_size = torch.sqrt(inv_intrinsics[:, 0, 0] ** 2 + inv_intrinsics[:, 1, 1] ** 2)
            scaled = (pixel_size * self.focal_factor)[:, None, None]
            depth = [d / scaled for d in depth]
        return depth


@register_meta_arch("DD3DDenseDepth")
def build_dd3d_dense_depth(cfg) -> DD3DDenseDepth:
    backbone = build_feature_extractor(cfg)
    strides = [backbone.out_feature_strides[f] for f in backbone.out_features]
    c3 = cfg.DD3D.FCOS3D
    head = DenseDepthHead(
        backbone.out_channels, len(strides), c3.MEAN_DEPTH_PER_LEVEL,
        c3.STD_DEPTH_PER_LEVEL, num_convs=c3.NUM_CONVS, norm=c3.NORM, use_scale=c3.USE_SCALE,
        depth_scale_init_factor=c3.DEPTH_SCALE_INIT_FACTOR)
    model = DD3DDenseDepth(backbone, strides, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, head,
                           getattr(torch, cfg.TPU.COMPUTE_DTYPE), c3.SCALE_DEPTH_BY_FOCAL_LENGTHS,
                           c3.SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR, cfg.DD3D.FEATURE_LOCATIONS_OFFSET)
    assign_quant_paths(model)
    return model


def dd3d_dense_depth_losses(cfg, depth_preds: List[torch.Tensor], batch: Dict[str, torch.Tensor],
                            strides=None) -> Dict[str, torch.Tensor]:
    """The train step's loss of DD3DDenseDepth: the model's per-level
    full-resolution depth against the batch's sparse GT `depth` (B, H, W),
    with the config's depth range and loss weight (dense_depth.py:141-171)."""
    if "depth" not in batch:
        raise KeyError("DD3DDenseDepth training requires a 'depth' array in the batch (sparse GT depth; enable "
                       "MODEL.DEPTH_ON so the mapper keeps it)")
    f3d = cfg.DD3D.FCOS3D
    return dense_depth_losses(depth_preds, batch["depth"], beta=f3d.LOSS.SMOOTH_L1_BETA, min_depth=f3d.MIN_DEPTH,
                              max_depth=f3d.MAX_DEPTH, loss_weight=f3d.DEPTH_HEAD.LOSS_WEIGHT)


def dense_depth_losses(depth_preds: List[torch.Tensor], gt_depth: torch.Tensor, beta: float = 0.05,
                       min_depth: float = 0.1, max_depth: float = 80.0,
                       loss_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """Masked smooth-L1 a level, decayed by sqrt(2)^level
    (dense_depth_loss.py:28-36). The count of valid pixels is the global
    batch's (an all-reduce under torch.distributed), so each rank's losses
    are its share of the global-batch losses, as for DD3D's normalizers."""
    gt_depth = gt_depth.float()
    valid = (gt_depth >= min_depth) & (gt_depth <= max_depth)
    denom = torch.clamp(all_reduce_sum(valid.sum().float().detach()), min=1.0)
    losses = {}
    for lvl, pred in enumerate(depth_preds):
        elem = smooth_l1_loss(pred, gt_depth, beta)
        loss = torch.where(valid, elem, 0.0).sum() / denom
        losses[f"loss_dense_depth_lvl_{lvl}"] = loss_weight * loss / (math.sqrt(2.0) ** lvl)
    return losses
