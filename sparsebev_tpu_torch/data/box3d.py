"""Minimal 3D box structure (numpy, host-side; the port's copy of
``sparsebev_tpu/data/box3d.py``).

Re-provides the slice of mmdet3d LiDARInstance3DBoxes the reference exercises
(SURVEY.md section 2.7): bottom-center storage ``[x, y, z_bottom, w, l, h,
yaw, (vx, vy)]``, ``gravity_center``, in-place ``rotate``/``scale`` used by
GlobalRotScaleTransImage (loaders/pipelines/transforms.py:344-394), and range
filtering.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def quaternion_to_rotation_matrix(q: Sequence[float]) -> np.ndarray:
    """[w, x, y, z] quaternion -> 3x3 rotation matrix (pyquaternion layout)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


class Boxes3D:
    """LiDAR-frame 3D boxes, bottom-center convention, dims (w, l, h)."""

    def __init__(self, tensor: np.ndarray, box_dim: int = 9):
        tensor = np.asarray(tensor, dtype=np.float32).reshape(-1, box_dim)
        self.tensor = tensor
        self.box_dim = box_dim

    def __len__(self):
        return self.tensor.shape[0]

    @property
    def gravity_center(self) -> np.ndarray:
        center = self.tensor[:, :3].copy()
        center[:, 2] += self.tensor[:, 5] * 0.5
        return center

    @property
    def dims(self) -> np.ndarray:
        return self.tensor[:, 3:6]

    @property
    def yaw(self) -> np.ndarray:
        return self.tensor[:, 6]

    @property
    def velocity(self) -> np.ndarray:
        return self.tensor[:, 7:9] if self.box_dim > 7 else np.zeros((len(self), 2))

    def gravity_boxes(self) -> np.ndarray:
        """[M, 9] gravity-centered layout the head/loss consume
        (models/sparsebev_head.py:421-423)."""
        out = self.tensor[:, :9].copy()
        out[:, 2] += self.tensor[:, 5] * 0.5
        return out

    def rotate(self, angle: float) -> None:
        """Rotate around z by ``angle`` (mmdet3d v1.0 LiDAR convention:
        points right-multiplied by rot_mat_T; yaw += angle)."""
        c, s = np.cos(angle), np.sin(angle)
        rot_mat_t = np.array([[c, s], [-s, c]], dtype=np.float32)
        self.tensor[:, :2] = self.tensor[:, :2] @ rot_mat_t
        self.tensor[:, 6] += angle
        if self.box_dim > 7:
            self.tensor[:, 7:9] = self.tensor[:, 7:9] @ rot_mat_t

    def scale(self, scale_factor: float) -> None:
        self.tensor[:, :6] *= scale_factor
        if self.box_dim > 7:
            self.tensor[:, 7:9] *= scale_factor

    def in_range_bev(self, pc_range: Sequence[float]) -> np.ndarray:
        x, y = self.tensor[:, 0], self.tensor[:, 1]
        return ((x > pc_range[0]) & (y > pc_range[1])
                & (x < pc_range[3]) & (y < pc_range[4]))

    def __getitem__(self, item) -> "Boxes3D":
        return Boxes3D(self.tensor[item], self.box_dim)
