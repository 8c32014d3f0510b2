"""SparseBEV transformer decoder (counterpart of
``sparsebev_tpu/models/decoder.py``): ``num_layers`` iterations of ONE
weight-shared decoder layer, each running scale-adaptive self-attention
(SASA), adaptive spatio-temporal sampling, adaptive mixing, the FFN, the
classification / regression branches and box refinement.

Key names follow the reference state dict
(``transformer.decoder.decoder_layer.*``). Geometry, softmaxes, LN2d
statistics and the branch outputs are fp32; everything else computes in the
query features' dtype (the config's compute dtype).

Training (``deterministic=False``): dropout at the attention and FFN sites,
the denoising mask on the self-attention, the classification branch in every
layer, and gradients through the sampling op and the pack (autograd
Functions over the CUDA kernels). As in the JAX package the query boxes
carry no gradient into the attention's distance term nor into the velocity
warp, and each layer refines a detached box.

Layer remat (``with_cp``, on by default in training as in the JAX decoder,
whose ``nn.remat`` policy saves only the sampled features): a layer runs as
two non-reentrant ``torch.utils.checkpoint`` regions with the sampling call
between them. The first region (position MLP, SASA, the offsets, the point
geometry, the projection and the level weights) keeps its inputs and hands
out the sampling op's operands; the second (mixing, FFN, branches, refine)
keeps the sampled features. The sampling forward therefore runs once a layer
and its backward once a call, and its table gradient goes to the pack's
``TableGrad`` as without remat. The recompute draws the same dropout masks:
:func:`~.layers.checkpoint_with_generator` replays the regions with the
dropout generator's state at their first run. A recompute gives the same
bits, so the remat changes no number.

Debug dumps (``utils/dump.py``, the JAX hooks): with ``DUMP`` enabled the
self-attention saves ``sasa_tau``, the sampling saves ``sample_points_cam``
and ``sample_points_cam_valid_mask``, and the decoder sets the stage and
saves ``query_bbox``, ``bbox_pred`` and ``cls_score`` (sigmoid) after each
layer; every layer then classifies, as in the JAX decoder. Disabled, they
cost one Python test each.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_ops import decode_bbox
from ..ops.geometry import inverse_sigmoid
from ..ops.projection import (make_sample_points, sampling_4d_operands,
                              sampling_4d_sample)
from .layers import (FFN, LayerNorm, Linear, MultiheadAttention,
                     checkpoint_with_generator, dropout_generator)


class SparseBEVSelfAttention(nn.Module):
    """Scale-adaptive self attention: per-head distance decay
    ``attn_bias = -dist[q, q'] * tau[b, h, q]`` on the attention logits."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 pc_range: Sequence[float] = ()):
        super().__init__()
        self.num_heads = num_heads
        self.pc_range = list(pc_range)
        self.gen_tau = Linear(embed_dims, num_heads)
        self.attention = MultiheadAttention(embed_dims, num_heads)

    def forward(self, query_bbox, query_feat, pre_attn_mask=None,
                deterministic: bool = True):
        b, q, _ = query_bbox.shape
        # pairwise BEV center distances; no gradient to the boxes
        centers = decode_bbox(query_bbox.detach(),
                              self.pc_range)[..., :2].float()
        keys = centers
        diff = centers[:, :, None, :] - keys[:, None, :, :]
        dist = -torch.sqrt((diff * diff).sum(-1))                 # [B, Q, K]
        tau = self.gen_tau(query_feat).float()                    # [B, Q, H]
        tau = tau.permute(0, 2, 1)                                # [B, H, Q]
        attn_mask = dist[:, None, :, :] * tau[..., None]          # [B,H,Q,K]
        if pre_attn_mask is not None:   # query denoising group isolation
            attn_mask = attn_mask.masked_fill(pre_attn_mask[None, None],
                                              float("-inf"))
        return self.attention(
            query_feat, attn_mask=attn_mask.reshape(
                b * self.num_heads, q, keys.shape[1]),
            deterministic=deterministic)


class SparseBEVSampling(nn.Module):
    """Adaptive spatio-temporal sampling: offsets in the box frame,
    velocity-compensated across frames, per-level softmax weights."""

    def __init__(self, embed_dims: int = 256, num_frames: int = 8,
                 num_groups: int = 4, num_points: int = 4,
                 num_levels: int = 4, pc_range: Sequence[float] = (),
                 num_views: int = 6):
        super().__init__()
        self.num_frames = num_frames
        self.num_groups = num_groups
        self.num_points = num_points
        self.num_levels = num_levels
        self.pc_range = list(pc_range)
        self.num_views = num_views
        self.sampling_offset = Linear(embed_dims,
                                      num_groups * num_points * 3)
        self.scale_weights = Linear(embed_dims,
                                    num_groups * num_points * num_levels)

    def forward(self, query_bbox, query_feat, lidar2img, time_diff, image_h,
                image_w):
        """The sampling op's locations and level weights (see
        ``ops/projection.py::sampling_4d_operands``); :meth:`sample` makes
        the call."""
        b, q = query_bbox.shape[:2]
        g, p, t = self.num_groups, self.num_points, self.num_frames
        offset = self.sampling_offset(query_feat).reshape(b, q, g * p, 3)
        pts = make_sample_points(query_bbox, offset.float(), self.pc_range)
        # T-expanded points built directly in query-major (q, b, g, t, p)
        base_q = pts.reshape(b, q, g, p, 3).permute(1, 0, 2, 3, 4)
        base_q = base_q[:, :, :, None]                        # [Q,B,G,1,P,3]
        # velocity warp: move past-frame samples back along -v * dt
        vel = query_bbox[..., 8:10].detach()
        dist = vel[:, :, None, :] * time_diff[:, None, :, None]   # [B,Q,T,2]
        dist_q = dist.permute(1, 0, 2, 3)[:, :, None, :, None, :]
        pts_q = torch.cat([base_q[..., 0:2] - dist_q,
                           base_q[..., 2:3].expand(q, b, g, t, p, 1)],
                          dim=-1)                             # [Q,B,G,T,P,3]
        sw = self.scale_weights(query_feat).reshape(
            b, q, g, 1, p, self.num_levels).float()
        sw = torch.softmax(sw, dim=-1).expand(b, q, g, t, p, self.num_levels)
        return sampling_4d_operands(pts_q, sw, lidar2img, image_h, image_w,
                                    num_views=self.num_views)

    def sample(self, packed, loc, sw, b: int):
        """The sampling call: ``[B, Q, G, T*P, C]``."""
        return sampling_4d_sample(packed, loc, sw, b, self.num_groups,
                                  self.num_frames, self.num_views)


def _ln2d(t, eps: float = 1e-5):
    """Parameter-free LayerNorm over the trailing 2 dims, fp32 statistics as
    E[x^2] - E[x]^2 (the JAX package's formulation)."""
    t32 = t.float()
    n = t.shape[-1] * t.shape[-2]
    s1 = t32.sum(dim=(-2, -1)) / n
    s2 = (t32 * t32).sum(dim=(-2, -1)) / n
    var = (s2 - s1 * s1).clamp(min=0.0)
    rs = torch.rsqrt(var + eps)
    return (t32 - s1[..., None, None]) * rs[..., None, None]


class AdaptiveMixing(nn.Module):
    """AdaMixer-style dynamic channel + point mixing (query, input and
    output widths all ``in_dim``, as the decoder uses it)."""

    def __init__(self, in_dim: int, in_points: int, n_groups: int = 4,
                 out_points: int = 128):
        super().__init__()
        self.in_dim = in_dim
        self.n_groups = n_groups
        self.in_points = in_points
        self.out_points = out_points
        self.eff = in_dim // n_groups
        self.m_params = self.eff * self.eff
        self.s_params = in_points * out_points
        self.parameter_generator = Linear(
            in_dim, n_groups * (self.m_params + self.s_params))
        self.out_proj = Linear(self.eff * out_points * n_groups, in_dim)

    def forward(self, x, query):
        b, q, g, p, c = x.shape
        if (g, p, c) != (self.n_groups, self.in_points, self.eff):
            raise ValueError(f"sampled features {tuple(x.shape)} do not match "
                             "the mixing layer")
        cdt = query.dtype
        params = self.parameter_generator(query).reshape(
            b * q, g, self.m_params + self.s_params)
        m = params[..., :self.m_params].reshape(b * q, g, c, c)
        s = params[..., self.m_params:].reshape(b * q, g, self.out_points,
                                                self.in_points)
        out = x.reshape(b * q, g, p, c).to(cdt)
        out = torch.matmul(out, m)                 # channel mixing
        out = F.relu(_ln2d(out)).to(cdt)
        out = torch.matmul(s, out)                 # point mixing
        out = F.relu(_ln2d(out)).to(cdt)
        out = self.out_proj(out.reshape(b * q, -1))
        return query + out.reshape(b, q, self.in_dim)


class SparseBEVTransformerDecoderLayer(nn.Module):
    """One decoder iteration: pos-MLP -> SASA -> sampling -> mixing -> FFN
    -> cls/reg -> refine."""

    def __init__(self, embed_dims: int, num_frames: int = 8,
                 num_points: int = 4, num_levels: int = 4,
                 num_classes: int = 10, code_size: int = 10,
                 pc_range: Sequence[float] = (), num_groups: int = 4,
                 mixer_out_points: int = 128, num_views: int = 6):
        super().__init__()
        c = embed_dims
        self.num_frames = num_frames
        self.position_encoder = nn.Sequential(
            Linear(3, c), LayerNorm(c), nn.ReLU(),
            Linear(c, c), LayerNorm(c), nn.ReLU())
        self.self_attn = SparseBEVSelfAttention(c, 8, pc_range)
        self.sampling = SparseBEVSampling(
            c, num_frames=num_frames, num_groups=num_groups,
            num_points=num_points, num_levels=num_levels, pc_range=pc_range,
            num_views=num_views)
        self.mixing = AdaptiveMixing(
            in_dim=c, in_points=num_points * num_frames, n_groups=num_groups,
            out_points=mixer_out_points)
        self.ffn = FFN(c, feedforward_channels=512)
        self.norm1 = LayerNorm(c)
        self.norm2 = LayerNorm(c)
        self.norm3 = LayerNorm(c)
        self.cls_branch = nn.Sequential(
            Linear(c, c), LayerNorm(c), nn.ReLU(),
            Linear(c, c), LayerNorm(c), nn.ReLU(),
            Linear(c, num_classes))
        self.reg_branch = nn.Sequential(
            Linear(c, c), nn.ReLU(), Linear(c, c), nn.ReLU(),
            Linear(c, code_size))

    @staticmethod
    def refine_bbox(bbox_proposal, bbox_delta):
        xyz = inverse_sigmoid(bbox_proposal[..., 0:3])
        xyz_new = torch.sigmoid(bbox_delta[..., 0:3] + xyz)
        return torch.cat([xyz_new, bbox_delta[..., 3:]], dim=-1)

    def forward(self, query_bbox, query_feat, packed, lidar2img, time_diff,
                image_h, image_w, with_cls: bool = True, attn_mask=None,
                deterministic: bool = True, remat: bool = False):
        """One iteration; ``remat`` runs it as the two checkpointed regions
        of the module docstring. ``queries``: this rank's range of a
        query-sharded head (see :class:`SparseBEVSelfAttention`)."""
        attend = functools.partial(self._attend, image_h=image_h,
                                   image_w=image_w, attn_mask=attn_mask,
                                   deterministic=deterministic)
        refine = functools.partial(self._refine, with_cls=with_cls,
                                   deterministic=deterministic)
        if remat:
            gen = dropout_generator(self)
            query_feat, loc, sw = checkpoint_with_generator(
                attend, query_bbox, query_feat, lidar2img, time_diff,
                generator=gen)
        else:
            query_feat, loc, sw = attend(query_bbox, query_feat, lidar2img,
                                         time_diff)
        sampled = self.sampling.sample(packed, loc, sw, query_bbox.shape[0])
        if remat:
            return checkpoint_with_generator(refine, query_bbox, query_feat,
                                             sampled, time_diff,
                                             generator=gen)
        return refine(query_bbox, query_feat, sampled, time_diff)

    def _attend(self, query_bbox, query_feat, lidar2img, time_diff, image_h,
                image_w, attn_mask, deterministic):
        """pos-MLP -> SASA -> the sampling operands."""
        cdt = query_feat.dtype
        query_feat = query_feat + self.position_encoder(
            query_bbox[..., :3].to(cdt))
        query_feat = self.norm1(self.self_attn(
            query_bbox, query_feat, attn_mask, deterministic))
        loc, sw = self.sampling(query_bbox, query_feat, lidar2img, time_diff,
                                image_h, image_w)
        return query_feat, loc, sw

    def _refine(self, query_bbox, query_feat, sampled, time_diff, with_cls,
                deterministic):
        """mixing -> FFN -> cls / reg branches -> refine."""
        query_feat = self.norm2(self.mixing(sampled, query_feat))
        query_feat = self.norm3(self.ffn(query_feat, deterministic))

        # at inference the decoder skips the cls branch on all but the last
        # layer: only the last layer's classification is ever decoded
        cls_score = self.cls_branch(query_feat).float() if with_cls else None
        bbox_pred = self.reg_branch(query_feat).float()
        bbox_pred = self.refine_bbox(query_bbox, bbox_pred)
        # absolute velocity: divide by dt of the first history frame
        if self.num_frames > 1:
            dt = time_diff[:, 1:2, None]
            dt = torch.where(dt < 1e-5, torch.ones_like(dt), dt)
            bbox_pred = torch.cat([bbox_pred[..., :8],
                                   bbox_pred[..., 8:] / dt], dim=-1)
        return query_feat, cls_score, bbox_pred


class SparseBEVTransformerDecoder(nn.Module):
    """Runs the one weight-shared layer ``num_layers`` times; ``with_cp``
    remats each layer in training (module docstring)."""

    def __init__(self, num_layers: int, with_cp: bool = True,
                 **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.with_cp = with_cp
        self.decoder_layer = SparseBEVTransformerDecoderLayer(**layer_kwargs)

    def forward(self, query_bbox, query_feat, packed, lidar2img, time_diff,
                image_h, image_w, attn_mask=None, deterministic: bool = True):
        """Returns (cls_scores [L, B, Q, classes], bbox_preds [L, B, Q, 10]).
        At inference (``deterministic``) the first L-1 cls slots hold -1e4
        ("no object": sigmoid ~ 0); in training every layer classifies.
        ``queries``: this rank's range of a query-sharded head (the boxes
        and features given are that range's; so are the outputs)."""
        bbox_preds, cls_scores = [], []
        last = self.num_layers - 1
        remat = self.with_cp and not deterministic and torch.is_grad_enabled()
        for i in range(self.num_layers):
            query_feat, cls_score, bbox_pred = self.decoder_layer(
                query_bbox, query_feat, packed, lidar2img, time_diff,
                image_h, image_w,
                with_cls=(not deterministic or i == last),
                attn_mask=attn_mask, deterministic=deterministic,
                remat=remat)
            query_bbox = bbox_pred.detach()
            bbox_preds.append(bbox_pred)
            cls_scores.append(cls_score)
        if deterministic:
            skipped = torch.full((last,) + cls_score.shape, -1e4,
                                 dtype=cls_score.dtype,
                                 device=cls_score.device)
            cls_scores = torch.cat([skipped, cls_score[None]], dim=0)
        else:
            cls_scores = torch.stack(cls_scores)
        return (torch.nan_to_num(cls_scores),
                torch.nan_to_num(torch.stack(bbox_preds)))


class SparseBEVTransformer(nn.Module):
    def __init__(self, embed_dims: int, num_layers: int = 6, **layer_kwargs):
        super().__init__()
        self.decoder = SparseBEVTransformerDecoder(
            num_layers, embed_dims=embed_dims, **layer_kwargs)

    def forward(self, *args, **kwargs):
        return self.decoder(*args, **kwargs)
