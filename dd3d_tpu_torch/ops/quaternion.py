"""Batched quaternion math, counterpart of dd3d_tpu/ops/quaternion.py.
Convention: real-first (w, x, y, z). All functions are batched over leading
dimensions. The 3x3 products are broadcast-multiply-sums in true fp32, never
a matmul that TF32 could round."""
import torch

EPS = 1e-9


def matmul3x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3)."""
    return torch.sum(m * v[..., None, :], dim=-1)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = quat.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion: the four
    candidate quaternions, selected by the largest denominator."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=1e-12))
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    cand = cand / (2.0 * torch.clamp(q_abs, min=0.1))[..., None]
    best = torch.argmax(q_abs, dim=-1)  # first maximum, as jnp.argmax
    quat = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return normalize_quaternion(quat)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions, batched."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def normalize_quaternion(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=EPS)
