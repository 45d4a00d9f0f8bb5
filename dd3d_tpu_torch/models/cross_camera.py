"""Host-side 3D box geometry of the drawing code: the port's copy of the part
of dd3d_tpu/models/cross_camera.py that the visualizers use (`_corners_np`,
`boxes_to_bev5_np`, :27-60). The rotated BEV NMS and the nuScenes
cross-camera aggregation of that module are not ported (ROADMAP §1 items 7
and 9).
"""
from typing import Optional

import numpy as np

from dd3d_tpu_torch.structures.pose import Pose, _quat_to_matrix_np

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
