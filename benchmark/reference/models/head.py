"""SparseBEV head (counterpart of ``sparsebev_tpu/models/head.py``):
grid-initialized query boxes, the "no object" query feature, the DN-DETR
denoising queries (static shapes: ground truth padded to ``max_gt`` a sample,
``dn_groups * max_gt`` denoising slots, invalid slots zeroed and masked in
the loss; the noising itself is ``losses/denoising.py``), the decoder, and
the reorder of the predicted boxes into the normalized world layout.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.msmv_sampling import PackedFeatures, pack_mlvl_feats_grouped
from .decoder import SparseBEVTransformer


def _per_level(spec, n):
    return (spec,) * n if isinstance(spec, (bool, int)) else tuple(spec)


def check_table_options(num_levels: int, table_yfold=True, table_fp8=False,
                        table_split=1, table_gsplit=False,
                        table_gsplit_pack=False,
                        num_frames: Optional[int] = None) -> None:
    """Check the per-level table modes (``table_yfold``), fp8 streaming
    rings (``table_fp8``), chunk-split streaming rings (``table_split``, an
    int or one entry a level) and the group-split options. A split above 1
    raises the JAX package's ``ValueError``s (``inference.py::
    ring_table_splits`` :85, ``ops/msmv_sampling.py::ring_init`` :376-398,
    ``_yfold_forward`` :1026) when it does not divide ``num_frames`` (the
    split ring's slot count), when its level is not y-fold and when its
    level is also group-split. (A ring that mixes split and group-split levels
    fails where JAX's forward asserts it, when the streaming ring is
    viewed: ``PackedFeatures``.)"""
    for name, spec in (("table_yfold", table_yfold),
                       ("table_fp8", table_fp8),
                       ("table_split", table_split),
                       ("table_gsplit", table_gsplit),
                       ("table_gsplit_pack", table_gsplit_pack)):
        if len(_per_level(spec, num_levels)) != num_levels:
            raise ValueError(f"{name}={spec!r} does not have one entry per "
                             f"level ({num_levels} levels)")
    splits = tuple(int(s) for s in _per_level(table_split, num_levels))
    yfold = _per_level(table_yfold, num_levels)
    gsplit = _per_level(table_gsplit, num_levels)
    for sp, yf, gs in zip(splits, yfold, gsplit):
        if sp < 1:
            raise ValueError(f"table_split={table_split!r} must be positive")
        if sp == 1:
            continue
        if num_frames is not None and num_frames % sp:
            raise ValueError(f"table_split={splits} must divide "
                             f"num_frames={num_frames}")
        if not yf:
            raise ValueError("table_split requires a yfold level")
        if gs:
            raise ValueError("table_split and table_gsplit are mutually "
                             "exclusive per level")


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
                 table_gsplit=False, table_gsplit_pack=False,
                 table_round=None):
        super().__init__()
        # a dtype the train / offline pack's tables are rounded through
        # (the lower-precision control); None: exact tables
        self.table_round = table_round
        check_table_options(num_levels, table_yfold, table_fp8, table_split,
                            table_gsplit, table_gsplit_pack, num_frames)
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.num_query = num_query
        self.num_frames = num_frames
        self.num_groups = num_groups
        self.num_views = num_views
        self.pc_range = list(pc_range)
        self.compute_dtype = compute_dtype
        # per-level table mode of the pack, the e4m3 levels of the
        # streaming ring (inference.ring_table_dtypes; training and offline
        # evaluation keep exact tables), and the group-split flags of the
        # streaming ring and of the train / offline pack (which pick the
        # pair levels' accumulation order)
        self.table_yfold = tuple(bool(v) for v in
                                 _per_level(table_yfold, num_levels))
        self.table_fp8 = tuple(bool(v) for v in
                               _per_level(table_fp8, num_levels))
        self.table_gsplit = tuple(bool(v) for v in
                                  _per_level(table_gsplit, num_levels))
        # chunks a level of the streaming ring (inference.ring_table_splits)
        self.table_split = tuple(int(v) for v in
                                 _per_level(table_split, num_levels))
        self.table_gsplit_pack = tuple(bool(v) for v in
                                       _per_level(table_gsplit_pack,
                                                  num_levels))
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

    def forward(self, mlvl_feats, lidar2img, time_diff, image_h: int,
                image_w: int, dn_inputs: Optional[dict] = None,
                deterministic: bool = True):
        """mlvl_feats: ring or frame tables (``PackedFeatures``, B' = B*T*G
        slices) or the raw pyramids, a list of ``[B, T*N, H, W, C]``, packed
        here once for all decoder layers; lidar2img [B, T*N, 4, 4];
        time_diff [B, T]. dn_inputs (training only): ``dn_query_bbox``
        [B, DN, 10] noised encoded boxes, ``dn_labels`` [B, DN] noised
        labels (``num_classes`` = padding), ``attn_mask`` [DN+Q, DN+Q] bool
        (True = blocked), optionally ``dn_mask`` [B, DN]. Returns the dict
        ``all_cls_scores [L, B, Q, classes]``, ``all_bbox_preds
        [L, B, Q, 10]`` and, when denoising, ``dn_cls_scores`` /
        ``dn_bbox_preds [L, B, DN, ...]``. ``query_group`` (a process
        group; None: unsharded): this rank runs its range of the DN + Q
        queries through the decoder and the predictions are
        gathered over the group, so every rank returns all of them."""
        if isinstance(mlvl_feats, PackedFeatures):
            packed = mlvl_feats
            b = packed.batch // (self.num_frames * self.num_groups)
        else:
            b = mlvl_feats[0].shape[0]
            packed = pack_mlvl_feats_grouped(
                list(mlvl_feats), self.num_views, self.num_groups,
                yfold=self.table_yfold, gsplit=self.table_gsplit_pack,
                table_round=self.table_round)
        c = self.in_channels
        query_bbox = self.init_query_bbox.weight[None].expand(
            b, self.num_query, 10)
        no_obj = self.label_enc.weight[self.num_classes]
        query_feat = torch.cat([no_obj, no_obj.new_zeros(1)])
        query_feat = query_feat[None, None].expand(b, self.num_query, c)
        if self.compute_dtype is not None:
            query_feat = query_feat.to(self.compute_dtype)

        attn_mask = None
        dn_pad = 0
        if dn_inputs is not None:
            dn_bbox = dn_inputs["dn_query_bbox"]
            attn_mask = dn_inputs["attn_mask"]
            dn_pad = dn_bbox.shape[1]
            dn_feat = self.label_enc(dn_inputs["dn_labels"].long())
            dn_feat = torch.cat([dn_feat, torch.ones_like(dn_feat[..., :1])],
                                dim=-1)
            if "dn_mask" in dn_inputs:  # zero features on padded slots
                dn_feat = torch.where(dn_inputs["dn_mask"][..., None],
                                      dn_feat, torch.zeros_like(dn_feat))
            query_bbox = torch.cat([dn_bbox.to(query_bbox.dtype),
                                    query_bbox], dim=1)
            query_feat = torch.cat([dn_feat.to(query_feat.dtype), query_feat],
                                   dim=1)

        cls_scores, bbox_preds = self.transformer(
            query_bbox, query_feat, packed, lidar2img.float(),
            time_diff.float(), image_h, image_w, attn_mask=attn_mask,
            deterministic=deterministic)

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
        if dn_pad > 0:
            return {"all_cls_scores": cls_scores[:, :, dn_pad:],
                    "all_bbox_preds": bbox_preds[:, :, dn_pad:],
                    "dn_cls_scores": cls_scores[:, :, :dn_pad],
                    "dn_bbox_preds": bbox_preds[:, :, :dn_pad]}
        return {"all_cls_scores": cls_scores, "all_bbox_preds": bbox_preds}
