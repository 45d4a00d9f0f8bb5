"""FCOS2D head, loss and shape-static inference decode, counterpart of
dd3d_tpu/models/fcos2d.py.

- `FCOS2DHead`: shared cls/box2d conv towers with per-level batch norms
  folded into each level's application of the shared kernel (static int8:
  each link fused into an s8 epilogue, `layers.run_tower`), predictors for
  class logits / ltrb box regression (relu'd) / centerness, learnable
  per-level `Scale` on the box regression. With `version` "v1"
  (DD3D.FCOS2D._VERSION) the tower convs add a bias before the per-level
  norm; any other version has none (dd3d_tpu/models/fcos2d.py:78-96).
- `fcos2d_loss`: sigmoid focal (cls) + centerness-weighted gIoU (box) + BCE
  (centerness), normalized by GLOBAL batch sums (positive count, centerness
  sum), never per image; with a process group the sums run over every
  rank's batch.
- `decode_fcos2d_level`: fixed-size top-k candidate selection per level.
"""
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models.layers import PredictorConv, Scale, TowerConv, fused_predictor_apply, run_tower
from dd3d_tpu_torch.ops.losses import iou_loss_ltrb_t, sigmoid_bce, sigmoid_focal_loss
from dd3d_tpu_torch.ops.nms import NEG_INF
from dd3d_tpu_torch.utils.comm import all_reduce_sum


class FCOS2DHead(nn.Module):
    """Shared towers + predictors applied to each FPN level. Takes and
    returns per-level NCHW tensors."""

    def __init__(self, num_classes: int, in_channels: int, in_strides: Sequence[int],
                 num_cls_convs: int = 4, num_box_convs: int = 4, norm: str = "BN",
                 use_scale: bool = True, box2d_scale_init_factor: float = 1.0, version: str = "v2"):
        super().__init__()
        num_levels = len(in_strides)
        bias = version == "v1"
        self.cls_tower = nn.ModuleList([TowerConv(in_channels, num_levels, norm, bias) for _ in range(num_cls_convs)])
        self.box2d_tower = nn.ModuleList([TowerConv(in_channels, num_levels, norm, bias)
                                          for _ in range(num_box_convs)])
        self.cls_logits = PredictorConv(in_channels, num_classes)
        self.box2d_reg = PredictorConv(in_channels, 4)
        self.centerness = PredictorConv(in_channels, 1)
        self.scales_box2d_reg = (
            nn.ModuleList([Scale(float(s) * box2d_scale_init_factor) for s in in_strides]) if use_scale else None
        )

    def forward(self, features: List[torch.Tensor], return_cls_tower: bool = False):
        """Per-level (logits, box2d_reg, centerness), and the cls tower's
        outputs as a fourth list with `return_cls_tower` (NuscenesDD3D's
        attribute and speed predictors read them)."""
        logits, box_reg_out, ctr_out, cls_tower_out = [], [], [], []
        box_preds = [self.box2d_reg, self.centerness]
        for l, x in enumerate(features):
            # the cls tower's output has a second reader with return_cls_tower,
            # so its last link then stays a tensor
            x_cls = run_tower(self.cls_tower, x, l, None if return_cls_tower else [self.cls_logits])
            cls_tower_out.append(x_cls)
            x_box = run_tower(self.box2d_tower, x, l, box_preds)
            logits.append(self.cls_logits(x_cls))
            # box2d_reg + centerness both read the box tower output: one conv.
            reg, ctr = fused_predictor_apply(x_box, box_preds)
            if self.scales_box2d_reg is not None:
                reg = self.scales_box2d_reg[l](reg)
            box_reg_out.append(F.relu(reg))  # relu (improved FCOS), not exp
            ctr_out.append(ctr)
        if return_cls_tower:
            return logits, box_reg_out, ctr_out, cls_tower_out
        return logits, box_reg_out, ctr_out


def compute_ctrness_targets_t(reg_t: torch.Tensor) -> torch.Tensor:
    """(B, 4, P) ltrb -> (B, P) sqrt((min_lr / max_lr) * (min_tb / max_tb))."""
    l, t, r, b = reg_t.unbind(1)
    lr_ratio = torch.minimum(l, r) / torch.clamp(torch.maximum(l, r), min=1e-9)
    tb_ratio = torch.minimum(t, b) / torch.clamp(torch.maximum(t, b), min=1e-9)
    return torch.sqrt(torch.clamp(lr_ratio * tb_ratio, min=0.0))


def fcos2d_loss(logits_flat: torch.Tensor, box2d_reg_flat: torch.Tensor, centerness_flat: torch.Tensor,
                targets: Dict[str, torch.Tensor], focal_alpha: float = 0.25, focal_gamma: float = 2.0,
                loc_loss_type: str = "giou") -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Global-batch FCOS2D losses (dd3d_tpu/models/fcos2d.py:186-226) on
    component-major f32 maps: logits (B, C, P), box2d_reg (B, 4, P),
    centerness (B, P). Returns (losses, extra) with extra's loss_denom,
    centerness_targets and num_pos for the 3D loss.

    The normalizers (positive count, centerness sum) are the global batch's:
    with a process group, one all-reduce sums them over the ranks, and they
    are clamped after the sum. Each rank's losses are then its own share of
    the global-batch losses; training/train_step.py scales the backward and
    sums the logged values."""
    num_classes = logits_flat.shape[1]
    pos = targets["pos_mask"].float()
    box2d_tgt = targets["box2d_reg_targets"]
    ctr_targets = compute_ctrness_targets_t(box2d_tgt) * pos
    num_pos, ctr_sum = all_reduce_sum(torch.stack([pos.sum(), ctr_targets.sum()]).detach())
    num_pos = torch.clamp(num_pos, min=1.0)
    loss_denom = torch.clamp(ctr_sum, min=1e-6)

    iota_c = torch.arange(num_classes, device=logits_flat.device)[None, :, None]
    cls_target = (targets["labels"][:, None, :] == iota_c).float() * pos[:, None, :]
    loss_cls = sigmoid_focal_loss(logits_flat, cls_target, focal_alpha, focal_gamma).sum() / num_pos
    iou_elem = iou_loss_ltrb_t(box2d_reg_flat, box2d_tgt, loc_loss_type)
    loss_box2d = torch.sum(iou_elem * ctr_targets * pos) / loss_denom
    loss_ctr = torch.sum(sigmoid_bce(centerness_flat, ctr_targets) * pos) / num_pos

    losses = {"loss_cls": loss_cls, "loss_box2d_reg": loss_box2d, "loss_centerness": loss_ctr}
    extra = {"loss_denom": loss_denom, "centerness_targets": ctr_targets, "num_pos": num_pos}
    return losses, extra


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, ties broken by the LOWER index
    first — the order of jax.lax.top_k, which torch.topk does not promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_fcos2d_level(
    logits: torch.Tensor,  # (B, H, W, C)
    box2d_reg: torch.Tensor,  # (B, H, W, 4)
    centerness: torch.Tensor,  # (B, H, W, 1)
    locations: torch.Tensor,  # (H*W, 2)
    num_candidates: int,
    pre_nms_thresh: float,
    thresh_with_ctr: bool = True,
    use_approx_topk: bool = True,
) -> Dict[str, torch.Tensor]:
    """Fixed-size candidate selection for one FPN level.

    Returns per-candidate tensors of shape (B, K): score (sqrt'd), box
    (B, K, 4 xyxy), cls, loc_idx (into the level's H*W grid), locations
    (B, K, 2), valid. Padding candidates carry score NEG_INF.
    """
    b, h, w, c = logits.shape
    k = min(num_candidates, h * w * c)

    scores = torch.sigmoid(logits.float().reshape(b, h * w, c))
    ctr = torch.sigmoid(centerness.float().reshape(b, h * w, 1))
    reg = box2d_reg.float().reshape(b, h * w, 4)

    combined = scores * ctr
    candidate_mask = (combined if thresh_with_ctr else scores) > pre_nms_thresh

    n = h * w * c
    flat_scores = torch.where(candidate_mask, combined, NEG_INF).reshape(b, n)
    if use_approx_topk and k < n:
        # Blocked top-k (dd3d_tpu fcos2d.py:262-281): per-block max + first
        # argmax, then an exact top-k over the block maxima. A candidate lost
        # to a block collision shares its block with a higher-scored one a
        # few locations away — a near-duplicate 2D NMS suppresses anyway.
        block = max(1, n // (6 * k))
        nb = -(-n // block)
        padded = F.pad(flat_scores, (0, nb * block - n), value=NEG_INF)
        bm, am = padded.reshape(b, nb, block).max(dim=-1)  # first maximum on ties
        top_vals, block_idx = stable_topk(bm, k)
        in_block = torch.gather(am, 1, block_idx)
        top_idx = torch.clamp(block_idx * block + in_block, max=n - 1)
    else:
        top_vals, top_idx = stable_topk(flat_scores, k)
    loc_idx = top_idx // c
    cls_idx = top_idx % c
    valid = top_vals > NEG_INF / 2

    reg_k = torch.gather(reg, 1, loc_idx[..., None].expand(b, k, 4))
    loc_k = locations[loc_idx]  # (B, K, 2)
    boxes = torch.stack(
        [
            loc_k[..., 0] - reg_k[..., 0],
            loc_k[..., 1] - reg_k[..., 1],
            loc_k[..., 0] + reg_k[..., 2],
            loc_k[..., 1] + reg_k[..., 3],
        ],
        dim=-1,
    )
    score = torch.where(valid, torch.sqrt(torch.clamp(top_vals, min=0.0)), NEG_INF)
    return {"score": score, "box": boxes, "cls": cls_idx, "loc_idx": loc_idx, "locations": loc_k, "valid": valid}
