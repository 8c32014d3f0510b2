"""3D box codecs (counterpart of ``sparsebev_tpu/ops/box_ops.py``).

- world boxes ``[cx, cy, cz, w, l, h, yaw, (vx, vy)]``;
- normalized boxes ``[cx, cy, logw, logl, cz, logh, sin, cos, (vx, vy)]``,
  the layout of the losses and the matcher (:func:`normalize_bbox` /
  :func:`denormalize_bbox`);
- query boxes ``[x, y, z, logw, logl, logh, sin, cos, vx, vy]`` with xyz
  scaled to [0, 1] by the point-cloud range (:func:`encode_bbox` /
  :func:`decode_bbox`).
"""

from __future__ import annotations

import torch


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """World box [cx,cy,cz,w,l,h,rot,(vx,vy)] -> loss layout
    [cx,cy,logw,logl,cz,logh,sin,cos,(vx,vy)]."""
    rot = bboxes[..., 6:7]
    parts = [bboxes[..., 0:1], bboxes[..., 1:2],
             torch.log(bboxes[..., 3:4]), torch.log(bboxes[..., 4:5]),
             bboxes[..., 2:3], torch.log(bboxes[..., 5:6]),
             torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def encode_bbox(bboxes: torch.Tensor, pc_range=None) -> torch.Tensor:
    """World box -> query layout [x01,y01,z01,logw,logl,logh,sin,cos,(vx,vy)],
    xyz normalized to [0, 1] by ``pc_range`` when given."""
    xyz = bboxes[..., 0:3]
    if pc_range is not None:
        lo = torch.tensor(pc_range[0:3], dtype=bboxes.dtype,
                          device=bboxes.device)
        hi = torch.tensor(pc_range[3:6], dtype=bboxes.dtype,
                          device=bboxes.device)
        xyz = (xyz - lo) / (hi - lo)
    rot = bboxes[..., 6:7]
    parts = [xyz, torch.log(bboxes[..., 3:6]), torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, dim=-1)


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
