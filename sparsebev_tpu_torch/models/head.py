"""SparseBEV head at inference (counterpart of ``sparsebev_tpu/models/head.py``):
grid-initialized query boxes, the "no object" query feature, the decoder,
and the reorder of the predicted boxes into the normalized world layout.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .decoder import SparseBEVTransformer


def _per_level(spec, n):
    return (spec,) * n if isinstance(spec, (bool, int)) else tuple(spec)


def check_table_options(num_levels: int, table_yfold=True, table_fp8=False,
                        table_split=1, table_gsplit=False,
                        table_gsplit_pack=False) -> None:
    """Accept per-level table modes (``table_yfold``) and the group-split
    options; refuse the table modes that are not ported yet."""
    for name, spec in (("table_yfold", table_yfold),
                       ("table_fp8", table_fp8),
                       ("table_split", table_split),
                       ("table_gsplit", table_gsplit),
                       ("table_gsplit_pack", table_gsplit_pack)):
        if len(_per_level(spec, num_levels)) != num_levels:
            raise ValueError(f"{name}={spec!r} does not have one entry per "
                             f"level ({num_levels} levels)")
    if any(_per_level(table_fp8, num_levels)):
        raise NotImplementedError(
            "table_fp8 (fp8 streaming rings) is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    if any(int(s) != 1 for s in _per_level(table_split, num_levels)):
        raise NotImplementedError(
            "table_split > 1 (chunk-split streaming rings) is not ported yet "
            "(ROADMAP Queue 1 item 14)")


class SparseBEVHead(nn.Module):
    """Query-based detection head. Outputs per-layer class logits and boxes
    in the normalized layout [cx, cy, logw, logl, cz, logh, sin, cos, vx, vy]
    with xyz in world coordinates."""

    def __init__(self, num_classes: int, in_channels: int,
                 num_query: int = 900, num_frames: int = 8,
                 num_points: int = 4, num_layers: int = 6,
                 num_levels: int = 4, code_size: int = 10,
                 pc_range: Sequence[float] = (), num_groups: int = 4,
                 mixer_out_points: int = 128, num_views: int = 6,
                 compute_dtype: Optional[torch.dtype] = None,
                 table_yfold=True, table_fp8=False, table_split=1,
                 table_gsplit=False, table_gsplit_pack=False):
        super().__init__()
        check_table_options(num_levels, table_yfold, table_fp8, table_split,
                            table_gsplit, table_gsplit_pack)
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.num_query = num_query
        self.num_frames = num_frames
        self.num_groups = num_groups
        self.num_views = num_views
        self.pc_range = list(pc_range)
        self.compute_dtype = compute_dtype
        # per-level table mode of the pack and the group-split flags of the
        # streaming ring (which pick the pair levels' accumulation order)
        self.table_yfold = tuple(bool(v) for v in
                                 _per_level(table_yfold, num_levels))
        self.table_gsplit = tuple(bool(v) for v in
                                  _per_level(table_gsplit, num_levels))
        self.init_query_bbox = nn.Embedding(num_query, 10)
        # DAB-DETR style label embedding; row num_classes = "no object"
        self.label_enc = nn.Embedding(num_classes + 1, in_channels - 1)
        self.transformer = SparseBEVTransformer(
            embed_dims=in_channels, num_layers=num_layers,
            num_frames=num_frames, num_points=num_points,
            num_levels=num_levels, num_classes=num_classes,
            code_size=code_size, pc_range=pc_range, num_groups=num_groups,
            mixer_out_points=mixer_out_points, num_views=num_views)
        self.reset_query_bbox()

    @torch.no_grad()
    def reset_query_bbox(self, generator: Optional[torch.Generator] = None):
        """Reference query init: N(0, 1) with xy on a centered sqrt(Q) x
        sqrt(Q) grid in (0, 1), z = 0, log-h = 1.5, velocity 0."""
        q = self.num_query
        gs = math.isqrt(q)
        assert gs * gs == q, "num_query must be a square"
        w = torch.randn(q, 10, generator=generator)
        xs = (torch.arange(gs, dtype=torch.float32) + 0.5) / gs
        xx, yy = torch.meshgrid(xs, xs, indexing="ij")
        w[:, 0:2] = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
        w[:, 2:3] = 0.0
        w[:, 5:6] = 1.5
        w[:, 8:10] = 0.0
        self.init_query_bbox.weight.copy_(w)

    def forward(self, packed, lidar2img, time_diff, image_h: int,
                image_w: int):
        """packed: ring or frame tables (B' = B*T*G slices);
        lidar2img [B, T*N, 4, 4]; time_diff [B, T]. Returns the dict
        ``all_cls_scores [L, B, Q, classes]``, ``all_bbox_preds [L, B, Q, 10]``."""
        b = packed.batch // (self.num_frames * self.num_groups)
        c = self.in_channels
        query_bbox = self.init_query_bbox.weight[None].expand(
            b, self.num_query, 10)
        no_obj = self.label_enc.weight[self.num_classes]
        query_feat = torch.cat([no_obj, no_obj.new_zeros(1)])
        query_feat = query_feat[None, None].expand(b, self.num_query, c)
        if self.compute_dtype is not None:
            query_feat = query_feat.to(self.compute_dtype)

        cls_scores, bbox_preds = self.transformer(
            query_bbox, query_feat, packed, lidar2img.float(),
            time_diff.float(), image_h, image_w)

        # query layout -> normalized layout: xyz to world, reorder
        pc = torch.tensor(self.pc_range, dtype=bbox_preds.dtype,
                          device=bbox_preds.device)
        xyz = bbox_preds[..., 0:3] * (pc[3:6] - pc[0:3]) + pc[0:3]
        bbox_preds = torch.cat([
            xyz[..., 0:2],            # cx, cy
            bbox_preds[..., 3:5],     # log w, log l
            xyz[..., 2:3],            # cz
            bbox_preds[..., 5:10],    # log h, sin, cos, vx, vy
        ], dim=-1)
        return {"all_cls_scores": cls_scores, "all_bbox_preds": bbox_preds}
