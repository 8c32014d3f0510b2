"""Geometry primitives (counterpart of ``sparsebev_tpu/ops/geometry.py``):
the torch functions of the model, and ``compose_lidar2img`` in numpy for the
host-side sweep loaders."""

from __future__ import annotations

import numpy as np
import torch


def rotation_3d_in_axis(points: torch.Tensor, angles: torch.Tensor,
                        version: str = "v1.0.0") -> torch.Tensor:
    """Rotate ``points [..., P, 3]`` around the z axis by ``angles [..., 1]``.

    With the default (v1.0.0) convention a point is right-multiplied by
    ``[[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]``; ``version='v0.17.1'``
    flips the sine signs for old checkpoints. Written elementwise so the
    result is exact fp32 (no matrix-unit rounding).
    """
    angles = angles[..., 0]
    rot_sin = torch.sin(angles)
    rot_cos = torch.cos(angles)
    if version == "v0.17.1":
        rot_sin = -rot_sin
    c = rot_cos[..., None]
    s = rot_sin[..., None]
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    out_x = px * c - py * s
    out_y = px * s + py * c
    return torch.stack([out_x, out_y, pz], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically clamped logit."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def compose_lidar2img(ego2global_translation_curr,
                      ego2global_rotation_curr,
                      lidar2ego_translation_curr,
                      lidar2ego_rotation_curr,
                      sensor2global_translation_past,
                      sensor2global_rotation_past,
                      cam_intrinsic_past) -> np.ndarray:
    """4x4 matrix projecting current-keyframe lidar points into a (possibly
    past/future) camera image (reference loaders/pipelines/loading.py:9-32).
    Host-side numpy; used by the sweep loaders.

    Derivation: map lidar -> current ego -> global with the current pose,
    then global -> past camera with the past sensor pose, then apply the
    camera intrinsics. Returns the combined row-vector-convention matrix
    ``lidar2img`` such that ``pix_homo = lidar2img @ [x, y, z, 1]^T``.
    """
    e2g_r = np.asarray(ego2global_rotation_curr, dtype=np.float64)
    l2e_r = np.asarray(lidar2ego_rotation_curr, dtype=np.float64)
    e2g_t = np.asarray(ego2global_translation_curr, dtype=np.float64)
    l2e_t = np.asarray(lidar2ego_translation_curr, dtype=np.float64)
    s2g_r = np.asarray(sensor2global_rotation_past, dtype=np.float64)
    s2g_t = np.asarray(sensor2global_translation_past, dtype=np.float64)
    intrinsic = np.asarray(cam_intrinsic_past, dtype=np.float64)

    inv = np.linalg.inv
    # R, T express the past sensor pose in the current lidar frame.
    m = inv(e2g_r).T @ inv(l2e_r).T
    r = s2g_r @ m
    t = s2g_t @ m - (e2g_t @ m + l2e_t @ inv(l2e_r).T)

    lidar2cam_r = inv(r.T)
    lidar2cam_t = t @ lidar2cam_r.T

    lidar2cam_rt = np.eye(4)
    lidar2cam_rt[:3, :3] = lidar2cam_r.T
    lidar2cam_rt[3, :3] = -lidar2cam_t

    viewpad = np.eye(4)
    viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
    lidar2img = (viewpad @ lidar2cam_rt.T).astype(np.float32)
    return lidar2img
