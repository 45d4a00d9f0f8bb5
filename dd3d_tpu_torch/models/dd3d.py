"""DD3D meta-architecture (backbone -> FPN -> FCOS2D/FCOS3D heads), its
training loss and its shape-static inference decode, counterpart of
dd3d_tpu/models/dd3d.py.

`DD3D.forward` takes the JAX package's layout, (B, H, W, 3) uint8 BGR
images, and returns per-level head outputs as (B, H, W, C) views. Inside,
the modules run NCHW; permuting an NHWC tensor to NCHW gives channels_last
strides, so the whole network runs channels_last without a copy.

`dd3d_losses` is the training loss from the per-level head outputs and a
batch in the collate_batch schema (padded GT), in f32: dense target
assignment, the FCOS2D and FCOS3D losses.

`dd3d_inference` decodes to fixed-size (B, POST_NMS_TOPK) detections:
per-level blocked top-k -> 3D decode -> top-`TPU.NMS_CANDIDATES` cap with one
packed gather -> class-aware greedy NMS (the CUDA kernel on the card) ->
stable compaction (-> the rotated BEV NMS with DD3D.INFERENCE.DO_BEV_NMS).
"""
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from dd3d_tpu_torch.models import build_feature_extractor, register_meta_arch
from dd3d_tpu_torch.models.fcos2d import FCOS2DHead, decode_fcos2d_level, fcos2d_loss, stable_topk
from dd3d_tpu_torch.models.fcos3d import FCOS3DHead, decode_fcos3d_candidates, fcos3d_loss
from dd3d_tpu_torch.models.prepare_targets import build_location_bases, prepare_targets
from dd3d_tpu_torch.ops.geometry import unproject_points2d
from dd3d_tpu_torch.ops.locations import compute_feature_locations
from dd3d_tpu_torch.ops.nms import NEG_INF, batched_nms_padded
from dd3d_tpu_torch.ops.rotated_boxes import boxes3d_corners_to_bev_boxes, rotated_nms_padded
from dd3d_tpu_torch.ops.stem_conv import NormalizedFrames
from dd3d_tpu_torch.structures.boxes3d import generic_corners
from dd3d_tpu_torch.utils.convert_checkpoint import assign_quant_paths
from dd3d_tpu_torch.utils.profiling import annotate

HEAD_KEYS_2D = ("logits", "box2d_reg", "centerness")
HEAD_KEYS_3D = ("quat", "proj_ctr", "depth", "size", "conf")


class DD3D(nn.Module):
    """Backbone + heads; `strides` are the FPN levels' (8..128 for P3-P7,
    8..64 for P3-P6) and
    `dtype` the compute dtype (TPU.COMPUTE_DTYPE; parameters stay fp32)."""

    def __init__(self, backbone: nn.Module, strides: Sequence[int], pixel_mean, pixel_std,
                 fcos2d_head: FCOS2DHead, fcos3d_head: Optional[FCOS3DHead], dtype: torch.dtype):
        super().__init__()
        self.backbone = backbone
        self.strides = tuple(strides)
        self.fcos2d_head = fcos2d_head
        self.fcos3d_head = fcos3d_head
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(list(pixel_mean), dtype=torch.float32).view(1, 3, 1, 1))
        self.register_buffer("pixel_std", torch.tensor(list(pixel_std), dtype=torch.float32).view(1, 3, 1, 1))

    def preprocess_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float BGR -> normalized NCHW (channels_last
        strides) in the compute dtype; the normalization is fp32."""
        return NormalizedFrames(images, self.pixel_mean, self.pixel_std, self.dtype).normalized()

    def forward(self, images: torch.Tensor, return_cls_tower: bool = False):
        """Per-level (B, H, W, C) head outputs; with `return_cls_tower`, also
        the cls tower's per-level NCHW outputs, as (outputs, towers)."""
        if images.dtype == torch.uint8 and getattr(self.backbone, "reads_frames", False):
            # the frames themselves: the stem conv normalizes them (models/layers.py ConvNorm)
            feats = self.backbone(NormalizedFrames(images, self.pixel_mean, self.pixel_std, self.dtype))
        else:
            feats = self.backbone(self.preprocess_image(images))
        features = [feats[k] for k in sorted(feats, key=lambda k: int(k[1:]))]
        with annotate("forward.fcos2d"):
            head2d = self.fcos2d_head(features, return_cls_tower=return_cls_tower)
        heads = dict(zip(HEAD_KEYS_2D, head2d))
        if self.fcos3d_head is not None:
            with annotate("forward.fcos3d"):
                heads.update(zip(HEAD_KEYS_3D, self.fcos3d_head(features)))
        out = {k: [x.permute(0, 2, 3, 1) for x in v] for k, v in heads.items()}
        return (out, head2d[3]) if return_cls_tower else out


@register_meta_arch("DD3D")
def build_dd3d(cfg) -> DD3D:
    backbone = build_feature_extractor(cfg)
    strides = [backbone.out_feature_strides[f] for f in backbone.out_features]
    channels = backbone.out_channels
    fcos2d = FCOS2DHead(
        cfg.DD3D.NUM_CLASSES, channels, strides,
        num_cls_convs=cfg.DD3D.FCOS2D.NUM_CLS_CONVS,
        num_box_convs=cfg.DD3D.FCOS2D.NUM_BOX_CONVS,
        norm=cfg.DD3D.FCOS2D.NORM,
        use_scale=cfg.DD3D.FCOS2D.USE_SCALE,
        box2d_scale_init_factor=cfg.DD3D.FCOS2D.BOX2D_SCALE_INIT_FACTOR,
        version=cfg.DD3D.FCOS2D.get("_VERSION", "v2"),
    )
    fcos3d = None
    if cfg.MODEL.BOX3D_ON:
        c3 = cfg.DD3D.FCOS3D
        fcos3d = FCOS3DHead(
            cfg.DD3D.NUM_CLASSES, channels, strides, c3.MEAN_DEPTH_PER_LEVEL, c3.STD_DEPTH_PER_LEVEL,
            num_convs=c3.NUM_CONVS, norm=c3.NORM, use_scale=c3.USE_SCALE,
            depth_scale_init_factor=c3.DEPTH_SCALE_INIT_FACTOR,
            proj_ctr_scale_init_factor=c3.PROJ_CTR_SCALE_INIT_FACTOR,
            per_level_predictors=c3.PER_LEVEL_PREDICTORS, class_agnostic=c3.CLASS_AGNOSTIC_BOX3D,
        )
    model = DD3D(backbone, strides, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, fcos2d, fcos3d,
                 getattr(torch, cfg.TPU.COMPUTE_DTYPE))
    assign_quant_paths(model)  # int8 scales are keyed by the JAX package's scope paths
    return model


def flatten_levels_t(outputs: List[torch.Tensor]) -> torch.Tensor:
    """[per-level (B, H, W, C)] -> (B, C, P) f32, level-major along P."""
    b = outputs[0].shape[0]
    return torch.cat([x.float().permute(0, 3, 1, 2).reshape(b, x.shape[-1], -1) for x in outputs], dim=-1)


def model_strides(model) -> Tuple[int, ...]:
    """FPN strides of a built meta-arch."""
    return tuple(model.strides)


def dd3d_losses(cfg, outputs: Dict[str, List[torch.Tensor]], batch: Dict[str, torch.Tensor],
                strides: Sequence[int], return_aux: bool = False):
    """The DD3D training losses (dd3d_tpu/models/dd3d.py:191-235) from
    per-level (B, H, W, C) head outputs; `batch` holds gt_boxes2d,
    gt_classes, gt_boxes3d, gt_valid and intrinsics on the outputs' device.
    With `return_aux`: (losses, targets, extra), the dense targets and the
    2D loss's extra terms, which NuscenesDD3D's losses reuse."""
    device = outputs["logits"][0].device
    shapes = [x.shape[1:3] for x in outputs["logits"]]
    locations, loc_strides, loc_ranges, _ = build_location_bases(
        shapes, strides, cfg.DD3D.SIZES_OF_INTEREST, cfg.DD3D.FEATURE_LOCATIONS_OFFSET, device=device)
    targets = prepare_targets(
        locations, loc_strides, loc_ranges,
        batch["gt_boxes2d"], batch["gt_classes"], batch["gt_boxes3d"], batch["gt_valid"],
        num_classes=cfg.DD3D.NUM_CLASSES,
        center_sample=cfg.DD3D.FCOS3D.PREPARE_TARGET.CENTER_SAMPLE,
        pos_radius=cfg.DD3D.FCOS3D.PREPARE_TARGET.POS_RADIUS,
    )
    loss2d = cfg.DD3D.FCOS2D.LOSS
    losses, extra = fcos2d_loss(
        flatten_levels_t(outputs["logits"]), flatten_levels_t(outputs["box2d_reg"]),
        flatten_levels_t(outputs["centerness"])[:, 0], targets,
        focal_alpha=loss2d.ALPHA, focal_gamma=loss2d.GAMMA, loc_loss_type=loss2d.LOC_LOSS_TYPE,
    )
    if cfg.MODEL.BOX3D_ON:
        inv_k = torch.linalg.inv(batch["intrinsics"].float())
        canon = torch.tensor(cfg.DD3D.FCOS3D.CANONICAL_BOX3D_SIZES, dtype=torch.float32, device=device)
        losses.update(fcos3d_loss(
            *(flatten_levels_t(outputs[k]) for k in HEAD_KEYS_3D),
            targets, extra, inv_k, locations, canon, cfg.DD3D.FCOS3D,
        ))
    if return_aux:
        return losses, targets, extra
    return losses


def _gather_fields(d: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather every per-candidate field of `d` at `idx` (B, K) along dim 1
    with ONE row gather over the fields packed as f32 columns. Exact: the
    non-float fields are small ints or bools, which round-trip f32."""
    keys = sorted(d)
    cols, spec = [], {}
    for k in keys:
        v = d[k]
        a = v[..., None] if v.ndim == 2 else v
        spec[k] = (v.ndim, v.dtype, a.shape[-1])
        cols.append(a.float())
    packed = torch.cat(cols, dim=-1)
    g = torch.gather(packed, 1, idx[..., None].expand(idx.shape + (packed.shape[-1],)))
    out, off = {}, 0
    for k in keys:
        ndim, dt, c = spec[k]
        part = g[..., off: off + c]
        off += c
        if ndim == 2:
            part = part[..., 0]
        out[k] = part if dt == torch.float32 else part.to(dt)
    return out


def dd3d_inference(cfg, outputs: Dict[str, List[torch.Tensor]], intrinsics: Optional[torch.Tensor],
                   strides: Sequence[int], suppress=None, scan=None) -> Dict[str, torch.Tensor]:
    """Decode per-level (B, H, W, C) head outputs into fixed-size detections.

    Returns (B, D) tensors, D = POST_NMS_TOPK: boxes2d (B, D, 4), scores,
    classes, fpn_levels, valid, and with the 3D head scores_3d, conf3d and
    the boxes3d_* fields. Boxes are in network-input resolution.
    `suppress` replaces the NMS suppression (default: the kernel's wrapper,
    which runs the plain version on CPU tensors). With NuscenesDD3D's heads
    the detections also carry `attributes` (argmax) and `speeds`. With
    DD3D.INFERENCE.DO_BEV_NMS a rotated BEV NMS follows (`_bev_nms_in_graph`,
    in the span `decode.bev_nms`; `scan` replaces its suppression, default
    the CUDA scan's wrapper).
    """
    inf2d = cfg.DD3D.FCOS2D.INFERENCE
    box3d_on = cfg.MODEL.BOX3D_ON and ("quat" in outputs)
    device = outputs["logits"][0].device
    with annotate("decode.levels"):
        if box3d_on:
            canon = torch.tensor(cfg.DD3D.FCOS3D.CANONICAL_BOX3D_SIZES, dtype=torch.float32, device=device)
            inv_k = torch.linalg.inv(intrinsics.float())

        cands = []
        for l, stride in enumerate(strides):
            h, w = outputs["logits"][l].shape[1:3]
            locations = compute_feature_locations(h, w, stride, cfg.DD3D.FEATURE_LOCATIONS_OFFSET, device=device)
            cand = decode_fcos2d_level(
                outputs["logits"][l], outputs["box2d_reg"][l], outputs["centerness"][l], locations,
                num_candidates=cfg.TPU.PRE_NMS_CANDIDATES_PER_LEVEL,
                pre_nms_thresh=inf2d.PRE_NMS_THRESH,
                thresh_with_ctr=inf2d.THRESH_WITH_CTR,
                use_approx_topk=bool(cfg.TPU.get("USE_APPROX_TOPK", True)),
            )
            if box3d_on:
                cand.update(decode_fcos3d_candidates(
                    *(outputs[k][l] for k in HEAD_KEYS_3D), cand, inv_k, canon, cfg.DD3D.FCOS3D,
                    num_classes=cfg.DD3D.NUM_CLASSES, class_agnostic=cfg.DD3D.FCOS3D.CLASS_AGNOSTIC_BOX3D,
                ))
            if "attr_logits" in outputs:
                # NuscenesDD3D's attribute and speed at each candidate (dd3d_tpu/models/dd3d.py:342-349)
                attr = outputs["attr_logits"][l].float()
                attr = attr.reshape(attr.shape[0], -1, attr.shape[-1])
                idx = cand["loc_idx"]
                cand["attribute"] = torch.argmax(
                    torch.gather(attr, 1, idx[..., None].expand(idx.shape + attr.shape[-1:])), dim=-1)
                speed = outputs["speed"][l].float().reshape(attr.shape[0], -1)
                cand["speed"] = torch.gather(speed, 1, idx)
            cand["fpn_level"] = torch.full_like(cand["cls"], l)
            cand.pop("loc_idx")
            cands.append(cand)
        merged = {k: torch.cat([c[k] for c in cands], dim=1) for k in cands[0]}
    score_key = "score_3d" if box3d_on else "score"

    with annotate("decode.nms"):
        # Cap the NMS candidate pool: suppression is a serial walk over the
        # candidates, and only POST_NMS_TOPK boxes survive anyway.
        nms_cap = int(cfg.TPU.get("NMS_CANDIDATES", 512))
        total = merged[score_key].shape[1]
        pre_sorted = 0 < nms_cap < total
        if pre_sorted:
            _, top_idx = stable_topk(merged[score_key], nms_cap)
            merged = _gather_fields(merged, top_idx)
        nms_scores = merged[score_key]

        if inf2d.NMS_THRESH > 0 and cfg.DD3D.INFERENCE.DO_NMS:
            order, keep = batched_nms_padded(merged["box"], nms_scores, merged["cls"], inf2d.NMS_THRESH,
                                             inf2d.POST_NMS_TOPK, assume_sorted=pre_sorted, suppress=suppress)
        else:
            order = torch.sort(nms_scores, dim=1, descending=True, stable=True).indices
            rank = torch.arange(order.shape[1], device=device)[None]
            keep = torch.gather(merged["valid"], 1, order) & (rank < inf2d.POST_NMS_TOPK)

    with annotate("decode.outputs"):
        # Compact kept boxes to the front (stable: keeps score order), then
        # truncate to the fixed output size D.
        compact = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
        order = torch.gather(order, 1, compact)
        keep = torch.gather(keep, 1, compact)

        d = inf2d.POST_NMS_TOPK
        merged_sorted = _gather_fields(merged, order[:, :d])
        keep_d = keep[:, :d]
        result = {
            "boxes2d": merged_sorted["box"],
            "scores": torch.where(keep_d, torch.clamp(merged_sorted["score"], min=0.0), 0.0),
            "classes": merged_sorted["cls"],
            "fpn_levels": merged_sorted["fpn_level"],
            "valid": keep_d,
        }
        if "attribute" in merged_sorted:
            result["attributes"] = merged_sorted["attribute"]
            result["speeds"] = merged_sorted["speed"]
        if box3d_on:
            result["scores_3d"] = torch.where(keep_d, torch.clamp(merged_sorted["score_3d"], min=0.0), 0.0)
            for k in ("boxes3d_quat", "boxes3d_proj_ctr", "boxes3d_depth", "boxes3d_size", "conf3d"):
                result[k] = merged_sorted[k]
    if box3d_on and cfg.DD3D.INFERENCE.DO_BEV_NMS:
        with annotate("decode.bev_nms"):
            result = _bev_nms_in_graph(cfg, result, intrinsics, scan=scan)
    return result


def _bev_nms_in_graph(cfg, result: Dict[str, torch.Tensor], intrinsics: torch.Tensor,
                      scan=None) -> Dict[str, torch.Tensor]:
    """Per-image rotated BEV NMS over the final detections (JAX
    dd3d_tpu/models/dd3d.py:423-455; the reference's per-image path,
    core.py:137-151 -> layers/bev_nms.py:99-133): the boxes' top faces in
    BEV, their rotated IoU, class-aware greedy suppression through `scan`
    (default the CUDA scan's wrapper), and `valid` / the scores cut to the
    survivors."""
    inv_k = torch.linalg.inv(intrinsics.float())  # (B, 3, 3)
    tvec = unproject_points2d(result["boxes3d_proj_ctr"], inv_k) * result["boxes3d_depth"]
    corners = generic_corners(result["boxes3d_quat"], tvec, result["boxes3d_size"])
    bev5 = boxes3d_corners_to_bev_boxes(corners)  # (B, D, 5)
    scores = torch.where(result["valid"], result["scores_3d"], NEG_INF)
    order, keep_sorted = rotated_nms_padded(bev5, scores, result["classes"], cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH,
                                            suppress=scan)
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)  # back to the input positions
    valid = result["valid"] & keep
    out = dict(result)
    out["valid"] = valid
    out["scores"] = torch.where(valid, result["scores"], 0.0)
    out["scores_3d"] = torch.where(valid, result["scores_3d"], 0.0)
    return out
