"""Component-major geometry for the dense training losses, counterpart of
dd3d_tpu/models/loss_geometry.py: every map is (B, comp, P) with the
location axis P last, and the math is elementwise f32 on (B, P) slices, in
the JAX package's order. Quaternions are wxyz; rotation matrices are 9
row-major (B, P) components."""
from typing import Tuple

import torch

EPS = 1e-7

# signs of the 8 canonical corners in (l, w, h) object axes
_CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (1, -1, -1), (1, 1, -1),
    (-1, 1, 1), (-1, -1, 1), (-1, -1, -1), (-1, 1, -1),
)


def normalize_rows(x: torch.Tensor, dim: int = 1, eps: float = EPS) -> torch.Tensor:
    # the floor is inside the sqrt: a zero row gets finite gradients
    return x / torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=eps * eps))


def quaternion_to_matrix_t(quat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, 4, P) wxyz -> 9 (B, P) rotation components, row-major."""
    w, x, y, z = quat.unbind(1)
    two_s = 2.0 / torch.clamp(w * w + x * x + y * y + z * z, min=EPS)
    return (
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    )


def matrix_to_quaternion_t(m: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """9 row-major (B, P) components -> (B, 4, P) wxyz: the best-conditioned
    of pytorch3d's four candidates per element, first on ties."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    # floored at 1e-12, not 0: sqrt'(0) = inf would give 0 * inf = NaN
    # cotangents through the candidates that are not selected
    q_abs2 = (
        torch.clamp(1.0 + m00 + m11 + m22, min=1e-12),
        torch.clamp(1.0 + m00 - m11 - m22, min=1e-12),
        torch.clamp(1.0 - m00 + m11 - m22, min=1e-12),
        torch.clamp(1.0 - m00 - m11 + m22, min=1e-12),
    )
    q_abs = tuple(torch.sqrt(v) for v in q_abs2)

    def cand(i, comps):
        denom = 2.0 * torch.clamp(q_abs[i], min=0.1)
        return tuple(c / denom for c in comps)

    c0 = cand(0, (q_abs2[0], m21 - m12, m02 - m20, m10 - m01))
    c1 = cand(1, (m21 - m12, q_abs2[1], m01 + m10, m02 + m20))
    c2 = cand(2, (m02 - m20, m01 + m10, q_abs2[2], m12 + m21))
    c3 = cand(3, (m10 - m01, m20 + m02, m21 + m12, q_abs2[3]))

    best01 = q_abs[0] >= q_abs[1]
    best23 = q_abs[2] >= q_abs[3]
    a = tuple(torch.where(best01, x, y) for x, y in zip(c0, c1))
    a_abs = torch.where(best01, q_abs[0], q_abs[1])
    b = tuple(torch.where(best23, x, y) for x, y in zip(c2, c3))
    b_abs = torch.where(best23, q_abs[2], q_abs[3])
    bestab = a_abs >= b_abs
    return torch.stack([torch.where(bestab, x, y) for x, y in zip(a, b)], dim=1)


def unproject_t(xy: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """xy (B, 2, P) pixels + inv_K (B, 3, 3) -> rays (B, 3, P)."""
    k = inv_k[:, :, :, None]  # (B, 3, 3, 1)
    x, y = xy[:, 0], xy[:, 1]
    rows = [k[:, i, 0] * x + k[:, i, 1] * y + k[:, i, 2] for i in range(3)]
    return torch.stack(rows, dim=1)


def allocentric_to_egocentric_t(quat: torch.Tensor, proj_ctr: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """(B, 4, P) allocentric quat + (B, 2, P) projected centres -> (B, 4, P)
    egocentric quat (tridet/utils/geometry.py:15-55)."""
    r_obj = quaternion_to_matrix_t(quat)
    z = normalize_rows(unproject_t(proj_ctr, inv_k), dim=1)
    zx, zy, zz = z.unbind(1)
    # y = e_y - z_y * z, normalized; x = y cross z
    yx = -zy * zx
    yy = 1.0 - zy * zy
    yz = -zy * zz
    yn = torch.sqrt(torch.clamp(yx * yx + yy * yy + yz * yz, min=EPS * EPS))
    yx, yy, yz = yx / yn, yy / yn, yz / yn
    xx = yy * zz - yz * zy
    xy = yz * zx - yx * zz
    xz = yx * zy - yy * zx
    l2g = (xx, yx, zx, xy, yy, zy, xz, yz, zz)  # columns (x, y, z), row-major
    r_out = tuple(l2g[3 * i] * r_obj[j] + l2g[3 * i + 1] * r_obj[3 + j] + l2g[3 * i + 2] * r_obj[6 + j]
                  for i in range(3) for j in range(3))
    return normalize_rows(matrix_to_quaternion_t(r_out), dim=1)


def corners_t(quat: torch.Tensor, proj_ctr: torch.Tensor, depth: torch.Tensor, size: torch.Tensor,
              inv_k: torch.Tensor) -> torch.Tensor:
    """Box corners, component-major: quat (B, 4, P) wxyz, proj_ctr (B, 2, P),
    depth (B, P), size (B, 3, P) as (w, l, h), inv_K (B, 3, 3) -> (B, 24, P),
    8 corners x (x, y, z) in the order of structures/boxes3d.py."""
    r = quaternion_to_matrix_t(normalize_rows(quat, dim=1))
    ray = unproject_t(proj_ctr, inv_k)
    tx, ty, tz = ray[:, 0] * depth, ray[:, 1] * depth, ray[:, 2] * depth
    half_l, half_w, half_h = 0.5 * size[:, 1], 0.5 * size[:, 0], 0.5 * size[:, 2]  # wlh -> lwh
    rows = []
    for sx, sy, sz in _CORNER_SIGNS:
        cx, cy, cz = sx * half_l, sy * half_w, sz * half_h
        rows.append(r[0] * cx + r[1] * cy + r[2] * cz + tx)
        rows.append(r[3] * cx + r[4] * cy + r[5] * cz + ty)
        rows.append(r[6] * cx + r[7] * cy + r[8] * cz + tz)
    return torch.stack(rows, dim=1)
