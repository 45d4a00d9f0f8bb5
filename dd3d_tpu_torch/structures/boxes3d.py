"""3D box container, counterpart of dd3d_tpu/structures/boxes3d.py.

Vision parameterization (`Boxes3D`): quat (wxyz, 4) + projected center (2) +
depth (1) + size (w, l, h) (3) + per-box inverse intrinsics (3, 3); tvec is
derived by unprojecting the center. Corner math is always fp32.
"""
from typing import NamedTuple

import torch

from dd3d_tpu_torch.ops.geometry import unproject_points2d
from dd3d_tpu_torch.ops.quaternion import quaternion_to_matrix

# Sign pattern of the 8 box corners in the object frame (rows = corners,
# columns = x, y, z signs), in the reference's corner order.
CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (1, -1, -1), (1, 1, -1),
    (-1, 1, 1), (-1, -1, 1), (-1, -1, -1), (-1, 1, -1),
)


def generic_corners(quat: torch.Tensor, tvec: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) fp32 corners from quat (..., 4), tvec (..., 3) and size
    (..., 3) as (w, l, h); x spans length, y width, z height."""
    quat, tvec, size = quat.float(), tvec.float(), size.float()
    lwh = size[..., [1, 0, 2]]
    signs = torch.tensor(CORNER_SIGNS, dtype=torch.float32, device=size.device)
    corners_obj = 0.5 * lwh[..., None, :] * signs  # (..., 8, 3)
    R = quaternion_to_matrix(quat)  # (..., 3, 3)
    corners = torch.sum(R[..., None, :, :] * corners_obj[..., :, None, :], dim=-1)  # R @ p per corner
    return corners + tvec[..., None, :]


class Boxes3D(NamedTuple):
    """Vision-parameterized 3D boxes; all fields batched on the leading dims."""

    quat: torch.Tensor  # (..., 4) wxyz, camera frame
    proj_ctr: torch.Tensor  # (..., 2) projected center in pixels
    depth: torch.Tensor  # (..., 1) z-depth of the center
    size: torch.Tensor  # (..., 3) (w, l, h)
    inv_intrinsics: torch.Tensor  # (..., 3, 3)

    @property
    def tvec(self) -> torch.Tensor:
        """Center = unprojected ray * depth."""
        ray = unproject_points2d(self.proj_ctr.float(), self.inv_intrinsics.float())
        return ray * self.depth.float()

    @property
    def corners(self) -> torch.Tensor:
        return generic_corners(self.quat, self.tvec, self.size)

    def vectorize(self) -> torch.Tensor:
        """10-D representation [quat(4), tvec(3), size(3)]."""
        return torch.cat([self.quat.float(), self.tvec, self.size.float()], dim=-1)
