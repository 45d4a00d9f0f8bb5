"""Cross-camera (sample-level) BEV NMS on fixed-size tensors, counterpart of
dd3d_tpu/ops/sample_bev_nms.py (the reference's
tridet/modeling/dd3d/postprocessing.py:22-108, per sample of 6 cameras):
each camera's boxes are composed with its pose into the global frame,
turned into BEV rotated rectangles (the vehicle -> BEV axis swap only), and
suppressed by one class-aware rotated NMS over the whole sample, through the
CUDA scan on the card. Batched over samples: no host loop.
"""
from typing import Dict, Optional

import torch

from dd3d_tpu_torch.ops.geometry import unproject_points2d
from dd3d_tpu_torch.ops.nms import NEG_INF
from dd3d_tpu_torch.ops.quaternion import matvec3, quaternion_multiply, quaternion_to_matrix
from dd3d_tpu_torch.ops.rotated_boxes import VEHICLE_TO_BEV, corners_to_rotated_box, rotated_nms_padded, top_face_bev
from dd3d_tpu_torch.structures.boxes3d import generic_corners


def sample_bev_nms_in_graph(det: Dict[str, torch.Tensor], intrinsics: torch.Tensor, pose_quat: torch.Tensor,
                            pose_tvec: torch.Tensor, iou_threshold: float, max_dets: Optional[int] = 500,
                            scan=None) -> Dict[str, torch.Tensor]:
    """`det`: (S, C, D) detections of S samples of C cameras; intrinsics
    (S, C, 3, 3); pose_quat (S, C, 4) camera -> global wxyz; pose_tvec
    (S, C, 3). Returns `det` with `valid` cut by the global BEV NMS (at most
    `max_dets` kept a sample), `scores_3d` zeroed where it is cut, and the
    global-frame `quat_global` / `tvec_global` added. `scan(iou, valid,
    threshold)` replaces the suppression (default the CUDA scan's wrapper)."""
    s, c, d = det["valid"].shape
    inv_k = torch.linalg.inv(intrinsics.float())
    tvec_cam = unproject_points2d(det["boxes3d_proj_ctr"].float(), inv_k) * det["boxes3d_depth"].float()

    # camera -> global (postprocessing.py:24-50)
    pq = pose_quat.float()
    quat_g = quaternion_multiply(pq[:, :, None, :], det["boxes3d_quat"].float())
    r_pose = quaternion_to_matrix(pq)  # (S, C, 3, 3)
    tvec_g = matvec3(r_pose[:, :, None], tvec_cam) + pose_tvec.float()[:, :, None, :]

    corners = generic_corners(quat_g, tvec_g, det["boxes3d_size"].float())
    # already global: the vehicle -> BEV swap only (pose_cam_global=Pose(), postprocessing.py:55)
    bev5 = corners_to_rotated_box(top_face_bev(corners, VEHICLE_TO_BEV))  # (S, C, D, 5)

    scores = torch.where(det["valid"], det["scores_3d"].float(), NEG_INF).reshape(s, c * d)
    order, keep_sorted = rotated_nms_padded(bev5.reshape(s, c * d, 5), scores, det["classes"].reshape(s, c * d),
                                            iou_threshold, max_outputs=max_dets or 0, suppress=scan)
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted).reshape(s, c, d)

    out = dict(det)
    out["valid"] = det["valid"] & keep
    out["scores_3d"] = torch.where(out["valid"], det["scores_3d"], 0.0)
    out["quat_global"] = quat_g
    out["tvec_global"] = tvec_g
    return out
