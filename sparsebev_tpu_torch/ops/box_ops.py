"""3D box codecs (counterpart of ``sparsebev_tpu/ops/box_ops.py``).

- world boxes ``[cx, cy, cz, w, l, h, yaw, (vx, vy)]``;
- normalized boxes ``[cx, cy, logw, logl, cz, logh, sin, cos, (vx, vy)]``
  (:func:`denormalize_bbox` maps them back to world boxes);
- query boxes ``[x, y, z, logw, logl, logh, sin, cos, vx, vy]`` with xyz
  scaled to [0, 1] by the point-cloud range (:func:`decode_bbox`).
"""

from __future__ import annotations

import torch


def denormalize_bbox(normalized_bboxes: torch.Tensor) -> torch.Tensor:
    """Normalized layout -> world box [cx,cy,cz,w,l,h,rot,(vx,vy)]."""
    nb = normalized_bboxes
    rot = torch.atan2(nb[..., 6:7], nb[..., 7:8])
    parts = [nb[..., 0:1], nb[..., 1:2], nb[..., 4:5],
             torch.exp(nb[..., 2:3]), torch.exp(nb[..., 3:4]),
             torch.exp(nb[..., 5:6]), rot]
    if nb.shape[-1] > 8:
        parts += [nb[..., 8:9], nb[..., 9:10]]
    return torch.cat(parts, dim=-1)


def decode_bbox(bboxes: torch.Tensor, pc_range=None) -> torch.Tensor:
    """Query layout -> world box [cx,cy,cz,w,l,h,rot,(vx,vy)]."""
    xyz = bboxes[..., 0:3]
    if pc_range is not None:
        lo = torch.tensor(pc_range[0:3], dtype=bboxes.dtype,
                          device=bboxes.device)
        hi = torch.tensor(pc_range[3:6], dtype=bboxes.dtype,
                          device=bboxes.device)
        xyz = xyz * (hi - lo) + lo
    wlh = torch.exp(bboxes[..., 3:6])
    rot = torch.atan2(bboxes[..., 6:7], bboxes[..., 7:8])
    parts = [xyz, wlh, rot]
    if bboxes.shape[-1] > 8:
        parts.append(bboxes[..., 8:10])
    return torch.cat(parts, dim=-1)
