"""NuscenesDD3D meta-architecture: DD3D plus attribute and speed heads, and
their losses; counterpart of dd3d_tpu/models/nuscenes_dd3d.py (a rebuild of
`tridet/modeling/dd3d/nuscenes_dd3d.py`).

The attribute logits (DD3D.NUSC.MAX_NUM_ATTRIBUTES) and the ReLU'd speed are
3x3 predictors on the cls tower's outputs of each level, run as one conv
over their concatenated kernels (`layers.fused_predictor_apply`). The base
DD3D sits under `base`, as in the JAX module tree, so parameter names map to
flax paths by the same rules. TPU.PACKED_HEADS runs the plain path
(level_pack.py is a TPU layout, not ported).

`nuscenes_dd3d_losses` adds the attribute cross-entropy and the speed
smooth-L1 to the DD3D losses (JAX :85-148, NuscenesLoss of the reference,
nuscenes_dd3d.py:199-265).
"""
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models import register_meta_arch
from dd3d_tpu_torch.models.dd3d import DD3D, build_dd3d, dd3d_losses, flatten_levels_t
from dd3d_tpu_torch.models.layers import PredictorConv, fused_predictor_apply
from dd3d_tpu_torch.ops.losses import smooth_l1_loss
from dd3d_tpu_torch.utils.comm import all_reduce_sum
from dd3d_tpu_torch.utils.convert_checkpoint import assign_quant_paths


class NuscenesDD3D(nn.Module):
    """DD3D (`base`) plus attribute and speed predictors on its cls tower."""

    def __init__(self, base: DD3D, max_num_attributes: int = 4):
        super().__init__()
        self.base = base
        channels = base.fcos2d_head.cls_logits.weight.shape[1]
        self.attr_logits = PredictorConv(channels, max_num_attributes)
        self.speed = PredictorConv(channels, 1)

    @property
    def strides(self):
        return self.base.strides

    @property
    def pixel_mean(self) -> torch.Tensor:
        return self.base.pixel_mean

    def forward(self, images: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        out, towers = self.base(images, return_cls_tower=True)
        attr_out, speed_out = [], []
        for x in towers:
            attr, speed = fused_predictor_apply(x, [self.attr_logits, self.speed])
            attr_out.append(attr.permute(0, 2, 3, 1))
            speed_out.append(F.relu(speed).permute(0, 2, 3, 1))  # non-negative (nuscenes_dd3d.py:374)
        out["attr_logits"] = attr_out
        out["speed"] = speed_out
        return out


@register_meta_arch("NuscenesDD3D")
def build_nuscenes_dd3d(cfg) -> NuscenesDD3D:
    if cfg.TPU.get("QUANT_INT8", False):
        raise NotImplementedError("TPU.QUANT_INT8 with NuscenesDD3D: int8 serving of the nuScenes experiments is "
                                  "not ported (ROADMAP §1 item 13)")
    model = NuscenesDD3D(build_dd3d(cfg), cfg.DD3D.NUSC.MAX_NUM_ATTRIBUTES)
    assign_quant_paths(model)  # the flax scope paths under `base`
    return model


def nuscenes_dd3d_losses(cfg, outputs: Dict[str, List[torch.Tensor]], batch: Dict[str, torch.Tensor],
                         strides) -> Dict[str, torch.Tensor]:
    """The DD3D losses plus `loss_attr` and `loss_speed`; `batch` also holds
    gt_attributes (B, G), MAX_NUM_ATTRIBUTES - 1 meaning "ignore", and
    gt_speeds (B, G), NaN meaning "no speed".

    The attribute loss keeps the reference's quirk: the unweighted mean
    cross-entropy over the valid positive locations, times the summed
    centerness weights over max(that sum, 1e-6). The speed loss is the
    centerness-weighted smooth-L1 (beta 0.05) over the locations with a
    finite GT speed. Every normalizer is the global batch's: with a process
    group the sums run over every rank's batch (as `fcos2d_loss`'s)."""
    losses, targets, extra = dd3d_losses(cfg, outputs, batch, strides, return_aux=True)
    attr_flat = flatten_levels_t(outputs["attr_logits"])  # (B, A, P)
    speed_flat = flatten_levels_t(outputs["speed"])[:, 0]  # (B, P)
    num_attr = attr_flat.shape[1]
    device = attr_flat.device

    pos_mask = targets["pos_mask"]
    matched = torch.clamp(targets["target_inds"], min=0)
    num_gt = batch["gt_attributes"].shape[1]
    onehot_g = (matched[:, None, :] == torch.arange(num_gt, device=device)[None, :, None]).float()  # (B, G, P)
    attr_tgt = torch.sum(onehot_g * batch["gt_attributes"].float()[:, :, None], dim=1).to(torch.int64)
    # NaN GT speeds must not reach the contraction (NaN * 0 = NaN): finiteness
    # and the zero-filled value are selected apart
    gt_speeds = batch["gt_speeds"].float()
    finite = torch.isfinite(gt_speeds)
    speed_fin = torch.sum(onehot_g * finite.float()[:, :, None], dim=1) > 0.5
    speed_tgt = torch.sum(onehot_g * torch.where(finite, gt_speeds, 0.0)[:, :, None], dim=1)

    weights = extra["centerness_targets"]  # already pos-masked

    attr_valid = (attr_tgt < num_attr - 1) & pos_mask
    attr_safe = torch.where(attr_valid, attr_tgt, 0)
    logp = torch.log_softmax(attr_flat, dim=1)
    onehot_a = (attr_safe[:, None, :] == torch.arange(num_attr, device=device)[None, :, None]).float()
    xent = -torch.sum(logp * onehot_a, dim=1)  # (B, P)
    attr_valid_f = attr_valid.float()
    speed_valid = speed_fin & pos_mask
    speed_w = weights * speed_valid.float()
    n_valid, wsum, speed_denom = all_reduce_sum(
        torch.stack([attr_valid_f.sum(), (weights * attr_valid_f).sum(), speed_w.sum()]).detach())
    mean_xent = torch.sum(xent * attr_valid_f) / torch.clamp(n_valid, min=1.0)
    losses["loss_attr"] = cfg.DD3D.NUSC.LOSS.WEIGHT_ATTR * mean_xent * wsum / torch.clamp(wsum, min=1e-6)

    sl1 = smooth_l1_loss(speed_flat, torch.where(speed_valid, speed_tgt, 0.0), beta=0.05)
    losses["loss_speed"] = (cfg.DD3D.NUSC.LOSS.WEIGHT_SPEED * torch.sum(sl1 * speed_w)
                            / torch.clamp(speed_denom, min=1e-6))
    return losses
