"""Camera geometry ops, counterpart of dd3d_tpu/ops/geometry.py (the subset
the serving path uses), in true fp32."""
import torch

from dd3d_tpu_torch.ops.quaternion import matmul3x3, matrix_to_quaternion, matvec3, quaternion_to_matrix

EPS = 1e-7


def homogenize_points(xy: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 3) by appending ones."""
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def unproject_points2d(points2d: torch.Tensor, inv_K: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Lift pixel coordinates to rays: inv_K @ [x, y, 1].

    points2d: (N, ..., 2); inv_K: (3, 3) or (N, [...,] 3, 3) broadcastable
    against the points' leading dims."""
    pts = homogenize_points(points2d)
    k = inv_K
    while k.ndim > 2 and k.ndim - 2 < pts.ndim - 1:
        k = k[..., None, :, :]  # (N, 3, 3) -> (N, 1..., 3, 3)
    return matvec3(k, pts) * scale


def allocentric_to_egocentric(quat: torch.Tensor, proj_ctr: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Rotate an allocentric (viewing-ray local) orientation into the camera
    frame: Gram-Schmidt local frame from the ray through `proj_ctr`, then
    R_global = R_local_to_global @ R_obj_to_local.

    quat: (..., 4) wxyz; proj_ctr: (..., 2); inv_K: (..., 3, 3)."""
    R_obj_to_local = quaternion_to_matrix(quat)
    ray = unproject_points2d(proj_ctr, inv_K)
    z = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True), min=EPS)
    # local y = global y minus its projection on z (Gram-Schmidt).
    y = z.new_tensor([0.0, 1.0, 0.0]) - z[..., 1:2] * z
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=EPS)
    x = torch.linalg.cross(y, z, dim=-1)
    R_local_to_global = torch.stack([x, y, z], dim=-1)  # columns = local axes
    ego = matrix_to_quaternion(matmul3x3(R_local_to_global, R_obj_to_local))
    return ego / torch.clamp(torch.linalg.norm(ego, dim=-1, keepdim=True), min=EPS)
