"""Camera projection + spatio-temporal sampling (counterpart of
``sparsebev_tpu/ops/projection.py``): the box-frame sample-point placement
(:func:`make_sample_points`), the query-major projection with single-view
selection (:func:`project_points_qmajor`) and the fold into the sampling op
(:func:`sampling_4d`, which is :func:`sampling_4d_operands` then
:func:`sampling_4d_sample`).

One quirk of the reference is kept on purpose: scale weights fold as
``(B, G, T)`` while features and locations fold as ``(B, T, G)``. When
T != G this pairs feature group ``i % G`` with the weights generated for
group ``i // T`` — a fixed permutation trained checkpoints have adapted to.
"""

from __future__ import annotations

import torch

from .box_ops import decode_bbox
from .geometry import rotation_3d_in_axis
from .msmv_sampling import msmv_sampling


def make_sample_points(query_bbox: torch.Tensor, offset: torch.Tensor,
                       pc_range) -> torch.Tensor:
    """Place normalized offsets ``[B, Q, P, 3]`` in each query box's frame;
    ``query_bbox [B, Q, 10]``. Returns world points ``[B, Q, P, 3]``."""
    bbox = decode_bbox(query_bbox, pc_range)
    xyz = bbox[..., 0:3]
    wlh = bbox[..., 3:6]
    ang = bbox[..., 6:7]
    delta_xyz = offset[..., 0:3] * wlh[:, :, None, :]
    delta_xyz = rotation_3d_in_axis(delta_xyz, ang)
    return xyz[:, :, None, :] + delta_xyz


def project_points_qmajor(pts_q: torch.Tensor, lidar2img: torch.Tensor,
                          image_h: int, image_w: int, num_views: int = 6,
                          eps: float = 1e-5):
    """Project query-major points ``[Q, B, G, T, P, 3]`` through per-frame
    per-view matrices ``lidar2img [B, T*N, 4, 4]`` and pick one view per
    point: the first view that sees it (argmax over the valid mask; view 0
    when none does).

    Returns loc ``[Q, B*G*T, P, 3]`` (x, y in [0, 1], view / (N-1)) and
    valid ``[Q, B*G*T, P]`` (1.0 where the chosen view sees the point).
    """
    qq, b, g, t, p, _ = pts_q.shape
    n = num_views
    l2i = lidar2img.reshape(b, t, n, 4, 4).float()
    # the j = 4 contraction as fp32 multiply-adds (exact fp32 geometry)
    l2ib = l2i[None, :, None, :, None]            # [1, b, 1, t, 1, n, 4, 4]
    pb = pts_q[..., None, None, :]                # [q, b, g, t, p, 1, 1, 3]
    cam = (l2ib[..., 0] * pb[..., 0]
           + l2ib[..., 1] * pb[..., 1]
           + l2ib[..., 2] * pb[..., 2]
           + l2ib[..., 3])                        # [q, b, g, t, p, n, 4]
    homo = cam[..., 2]
    homo_nonzero = torch.clamp(homo, min=eps)
    xy = cam[..., 0:2] / homo_nonzero[..., None]
    xy = xy / torch.tensor([image_w, image_h], dtype=xy.dtype,
                           device=xy.device)
    valid = ((homo > eps)
             & (xy[..., 0] > 0.0) & (xy[..., 0] < 1.0)
             & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0))
    view = torch.argmax(valid.to(torch.uint8), dim=-1)       # first max
    xy_sel = torch.gather(
        xy, -2, view[..., None, None].expand(*view.shape, 1, 2))[..., 0, :]
    valid_sel = torch.gather(valid, -1, view[..., None])[..., 0].to(xy.dtype)
    view_coord = view.to(xy.dtype) / (n - 1)
    loc = torch.cat([xy_sel, view_coord[..., None]], dim=-1)
    return (loc.reshape(qq, b * g * t, p, 3),
            valid_sel.reshape(qq, b * g * t, p))



def sampling_4d_operands(sample_points_q: torch.Tensor,
                         scale_weights: torch.Tensor,
                         lidar2img: torch.Tensor, image_h: int, image_w: int,
                         num_views: int = 6, eps: float = 1e-5):
    """The sampling op's operands: the projected locations ``[Q, B*G*T, P,
    3]`` and the level weights ``[Q, B*G*T, P, L]`` (fp32), both in the
    (b, g, t) slice order of the points. (The decoder's layer remat keeps
    these two and the sampled features, and recomputes what makes them.)"""
    q, b, g, t, p, _ = sample_points_q.shape
    num_levels = scale_weights.shape[-1]
    dev = sample_points_q.device
    loc, _ = project_points_qmajor(sample_points_q, lidar2img, image_h,
                                   image_w, num_views, eps)
    # weight pairing keeps the (B, G, T) fold quirk: loc slice (g, t) — flat
    # position j = t*G + g within a sample — takes the weights at flat
    # position j of the (G, T)-folded weights, i.e. sw[b, j // T, j % T]
    jmat = (torch.arange(t, device=dev)[None, :] * g
            + torch.arange(g, device=dev)[:, None])           # [G, T]
    swf = scale_weights.reshape(b, q, g * t, p, num_levels)
    sw = torch.index_select(swf, 2, jmat.reshape(-1))         # [B,Q,GT,P,L]
    sw = sw.permute(1, 0, 2, 3, 4).reshape(q, b * g * t, p, num_levels)
    return loc.contiguous(), sw.float().contiguous()


def sampling_4d_sample(packed, loc: torch.Tensor, sw: torch.Tensor, b: int,
                       g: int, t: int, num_views: int = 6) -> torch.Tensor:
    """One :func:`msmv_sampling` call on the operands of
    :func:`sampling_4d_operands`; returns ``[B, Q, G, T*P, C]``. ``packed``
    as for :func:`sampling_4d`."""
    dev = loc.device
    q, _, p, _ = loc.shape

    # slice values for the (b, g, t) point order: the packed slice space is
    # (b, t, g)-ordered, composed with any ring slot indirection
    logical = ((torch.arange(b, device=dev)[:, None, None] * t
                + torch.arange(t, device=dev)[None, None, :]) * g
               + torch.arange(g, device=dev)[None, :, None]).reshape(b * g * t)
    if packed.slice_map is not None:
        logical = packed.slice_map.to(dev)[logical]
    view = packed.replace(batch=b * g * t, slice_map=logical)

    final = msmv_sampling(view, loc, sw)                      # [Q, BGT, P, C]
    c = final.shape[-1]
    final = final.reshape(q, b, g, t * p, c)
    return final.permute(1, 0, 2, 3, 4)                       # [B,Q,G,TP,C]
