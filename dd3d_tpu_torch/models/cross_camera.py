"""Cross-camera (multi-view sample) aggregation and global-frame BEV NMS on
the host, the port's copy of dd3d_tpu/models/cross_camera.py (a rebuild of
`tridet/modeling/dd3d/postprocessing.py`):
- the 3D box geometry the visualizers also use (`_corners_np`,
  `boxes_to_bev5_np`);
- `greedy_rotated_nms_np`: class-aware rotated NMS over unpacked
  detections, on the port's build of the C++ rotated IoU
  (evaluators/native.rotated_iou_matrix);
- `get_group_idxs` (images by sample token) and `nuscenes_sample_aggregate`:
  each sample's boxes in the global frame through one rotated NMS, at most
  `max_num_dets_per_sample`, split back per image.
This is the test-time-augmentation path, on detections already unpacked to
variable length; the serving path aggregates on the card
(ops/sample_bev_nms.py).
"""
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from dd3d_tpu_torch.structures.pose import Pose, _matrix_to_quat_np, _quat_to_matrix_np

# Rotation camera -> vehicle (z->x fwd, x->-y right, y->-z down), then
# vehicle -> BEV (dd3d_tpu/ops/rotated_boxes.py:21-23).
CAMERA_TO_VEHICLE = np.float32([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
VEHICLE_TO_BEV = np.float32([[0, -1, 0], [-1, 0, 0], [0, 0, -1]])
CAMERA_TO_BEV = VEHICLE_TO_BEV @ CAMERA_TO_VEHICLE

CORNER_SIGNS = np.array(
    [[1, 1, 1], [1, -1, 1], [1, -1, -1], [1, 1, -1], [-1, 1, 1], [-1, -1, 1], [-1, -1, -1], [-1, 1, -1]],
    dtype=np.float64,
)


def _corners_np(quat, tvec, size):
    """(N, 8, 3) f64 corners, the layout of structures/boxes3d.generic_corners."""
    lwh = size[:, [1, 0, 2]]
    corners_obj = 0.5 * lwh[:, None, :] * CORNER_SIGNS
    out = np.empty((len(quat), 8, 3))
    for i in range(len(quat)):
        r = _quat_to_matrix_np(quat[i] / np.linalg.norm(quat[i]))
        out[i] = corners_obj[i] @ r.T + tvec[i]
    return out


def boxes_to_bev5_np(quat, tvec, size, cam_to_global: Optional[Pose] = None):
    """Camera-frame boxes -> (N, 5) BEV rotated boxes [cx, cy, w, l, deg]."""
    corners = _corners_np(quat, tvec, size)
    if cam_to_global is not None:
        corners = corners @ cam_to_global.rotation_matrix.T + cam_to_global.tvec
        cam_to_bev = np.float64([[0, -1, 0], [-1, 0, 0], [0, 0, -1]])  # vehicle/world -> BEV only
    else:
        cam_to_bev = CAMERA_TO_BEV.astype(np.float64)
    top = corners[:, [0, 1, 5, 4], :]
    top_bev = (top @ cam_to_bev.T)[..., :2]
    fl, fr, br, bl = top_bev[:, 0], top_bev[:, 1], top_bev[:, 2], top_bev[:, 3]
    length = np.linalg.norm(fl - bl, axis=1)
    width = np.linalg.norm(fl - fr, axis=1)
    center = (fl + br) / 2
    forward = fl - bl
    angle = np.degrees(np.arctan2(forward[:, 0], forward[:, 1]))
    return np.stack([center[:, 0], center[:, 1], width, length, angle], axis=1)


def greedy_rotated_nms_np(boxes5, scores, classes, iou_threshold):
    """Sequential class-aware rotated NMS; the kept indices in score order
    (np.argsort(-scores), as JAX). Suppresses at IoU > threshold, as
    detectron2's batched_nms_rotated."""
    from dd3d_tpu_torch.evaluators.native import rotated_iou_matrix

    order = np.argsort(-scores)
    b = boxes5.copy().astype(np.float64)
    b[:, 4] = np.radians(b[:, 4])  # the C++ kernel takes radians
    iou = rotated_iou_matrix(b[order], b[order])
    keep = []
    suppressed = np.zeros(len(order), dtype=bool)
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        mask = (iou[i] > iou_threshold) & (classes[order] == classes[order[i]])
        mask[: i + 1] = False
        suppressed |= mask
    return np.asarray(keep, dtype=np.int64)


def get_group_idxs(sample_tokens: List[str], num_images_per_sample: int) -> Dict[str, List[int]]:
    """{sample token: image indices}, in first-seen order; every sample must
    hold `num_images_per_sample` images (postprocessing.py:111-129)."""
    grouped = defaultdict(list)
    for idx, token in enumerate(sample_tokens):
        grouped[token].append(idx)
    sizes = {t: len(v) for t, v in grouped.items()}
    if not all(s == num_images_per_sample for s in sizes.values()):
        raise ValueError(f"Group sizes do not match {num_images_per_sample}: {sizes}")
    return OrderedDict(grouped)


def nuscenes_sample_aggregate(per_image_dets: List[dict], group_idxs: Dict[str, List[int]], num_classes: int,
                              global_poses: List[Pose], iou_threshold: float,
                              max_num_dets_per_sample: Optional[int] = 500,
                              include_boxes3d_global: bool = True) -> List[dict]:
    """Each sample's detections across its cameras through one global BEV
    NMS. `per_image_dets`: unpacked per-image dicts with quat, tvec, size,
    scores_3d and classes; `global_poses`: each image's camera -> global
    Pose. Returns the per-image dicts cut to the survivors, with
    quat_global / tvec_global when `include_boxes3d_global`."""
    out = [None] * len(per_image_dets)
    for group_idx, (_token, idxs) in enumerate(group_idxs.items()):
        bev_list, score_list, cls_list, img_list, det_list = [], [], [], [], []
        glob_quat, glob_tvec = [], []
        for idx in idxs:
            det = per_image_dets[idx]
            pose = global_poses[idx]
            n = len(det["classes"])
            if n:
                # global-frame boxes (postprocessing.py:24-50)
                r_ws = pose.rotation_matrix
                quat_g = np.empty_like(det["quat"])
                for i in range(n):
                    r_wo = r_ws @ _quat_to_matrix_np(det["quat"][i] / np.linalg.norm(det["quat"][i]))
                    quat_g[i] = _matrix_to_quat_np(r_wo)
                tvec_g = det["tvec"] @ r_ws.T + pose.tvec
                # already global: the vehicle -> BEV swap only (the reference
                # passes pose_cam_global=Pose(), postprocessing.py:55)
                bev_list.append(boxes_to_bev5_np(quat_g, tvec_g, det["size"], cam_to_global=Pose()))
                glob_quat.append(quat_g)
                glob_tvec.append(tvec_g)
                score_list.append(det["scores_3d"])
                cls_list.append(det["classes"] + group_idx * num_classes)
                img_list.append(np.full(n, idx))
                det_list.append(np.arange(n))
        if not bev_list:
            for idx in idxs:
                out[idx] = per_image_dets[idx]
            continue
        bev = np.concatenate(bev_list)
        scores = np.concatenate(score_list)
        classes = np.concatenate(cls_list)
        img_ids = np.concatenate(img_list)
        det_ids = np.concatenate(det_list)
        gq = np.concatenate(glob_quat)
        gt = np.concatenate(glob_tvec)

        keep = greedy_rotated_nms_np(bev, scores, classes, iou_threshold)
        if max_num_dets_per_sample:
            keep = keep[:max_num_dets_per_sample]

        for idx in idxs:
            local = det_ids[keep[img_ids[keep] == idx]]
            det = per_image_dets[idx]
            new = {k: (v[local] if isinstance(v, np.ndarray) and len(v) == len(det["classes"]) else v)
                   for k, v in det.items()}
            if include_boxes3d_global:
                mask_all = img_ids == idx
                new["quat_global"] = gq[mask_all][local]
                new["tvec_global"] = gt[mask_all][local]
            out[idx] = new
    return out
