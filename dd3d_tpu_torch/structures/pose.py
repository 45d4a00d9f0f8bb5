"""Host-side SE(3) pose (numpy): the port's own copy of
dd3d_tpu/structures/pose.py, a rebuild of `tridet/structures/pose.py`.

Used by the data pipeline (dataset extrinsics/ego poses) and cross-camera
aggregation. Quaternion is wxyz (same convention as pyquaternion in the
reference).
"""
from __future__ import annotations

import numpy as np


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def _matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    # Shepperd's method.
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return q / np.linalg.norm(q)


class Pose:
    """Rigid transform: x_out = R(quat) @ x_in + tvec.

    Composition/inverse semantics mirror tridet/structures/pose.py:6-164.
    """

    def __init__(self, wxyz=(1.0, 0.0, 0.0, 0.0), tvec=(0.0, 0.0, 0.0)):
        self.quat = np.asarray(wxyz, dtype=np.float64)
        self.quat = self.quat / np.linalg.norm(self.quat)
        self.tvec = np.asarray(tvec, dtype=np.float64)

    @classmethod
    def from_matrix(cls, transformation_matrix: np.ndarray) -> "Pose":
        m = np.asarray(transformation_matrix, dtype=np.float64)
        if m.shape != (4, 4):
            raise ValueError(f"need a 4x4 matrix, got {m.shape}")
        return cls(wxyz=_matrix_to_quat_np(m[:3, :3]), tvec=m[:3, 3])

    @classmethod
    def identity(cls) -> "Pose":
        return cls()

    @property
    def matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = self.rotation_matrix
        m[:3, 3] = self.tvec
        return m

    @property
    def rotation_matrix(self) -> np.ndarray:
        return _quat_to_matrix_np(self.quat)

    def __mul__(self, other):
        """Compose with a pose, or transform (N, 3) points."""
        if isinstance(other, Pose):
            m = self.matrix @ other.matrix
            return Pose.from_matrix(m)
        pts = np.asarray(other, dtype=np.float64)
        return pts @ self.rotation_matrix.T + self.tvec

    def inverse(self) -> "Pose":
        R_inv = self.rotation_matrix.T
        t_inv = -R_inv @ self.tvec
        m = np.eye(4)
        m[:3, :3] = R_inv
        m[:3, 3] = t_inv
        return Pose.from_matrix(m)

    def __repr__(self) -> str:
        return f"Pose(quat={self.quat}, tvec={self.tvec})"
