"""Geometry primitives (counterpart of ``sparsebev_tpu/ops/geometry.py``)."""

from __future__ import annotations

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
