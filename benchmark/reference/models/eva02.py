"""EVA02 ViT backbone with the ViTDet SimpleFeaturePyramid, in plain torch.

A frozen copy of the port's ``sparsebev_tpu_torch/models/eva02.py`` for
inference: the plain ViT of EVA-02 (Fang et al., arXiv:2303.11331) with an
interpolated absolute position embedding, 2D rotary embeddings with
bicubic frequency interpolation to the real aspect ratio, a SwiGLU MLP
with sub-LN, windowed attention on most blocks and global attention on the
rest; then ViTDet's deconv / identity / max-pool pyramid (Li et al.,
arXiv:2203.16527) off the last feature, with an optional stride-2 top
level, as SparseBEV configures it
(``configs/vit_eva02_1600x640_trainval_future.py``).

Importing this module registers ``"EVA02"`` in
``reference.models.detector._BACKBONES``, so ``build_detector`` builds an
EVA02 detector from a config. Module names are the port's (detectron2's
state-dict keys), so the seeded state of ``harness/weights.py`` fills both
alike.

The order of floating-point operations is the port's plain path (the
seeded head amplifies one-ulp input changes far past any tolerance), and
every product is fp32 with TF32 off: the detector runs its backbone under
``utils/device.py::fp32_precision``. The attention is the port's
``eva_attention_plain``: fp32 logits scaled by ``hd ** -0.5``, softmax in
fp32, the probabilities in the value dtype, then the product with v, the
queries 512 at a time above 2,048 tokens (softmax runs over the keys, so
the chunks change no value). The RoPE tables are made from numpy at first
use on a device (never buffers), so a model built on ``meta`` computes the
same tables once given storage.

Departures from the published description, each the port's:

- the dtype flow of a bf16 compute dtype: the detector hands the backbone
  its images in the compute dtype, and this module takes that dtype as its
  own (the port's ``dtype``). The patch embed, the position add and the
  pyramid's (de)convolutions compute in it; every LayerNorm returns fp32,
  so from block 0's ``norm1`` on the trunk (projections, attention, SwiGLU)
  is fp32, and block 0 multiplies by RoPE tables rounded to the compute
  dtype. The published model runs its trunk in mixed precision; an fp32
  trunk is the port's choice (its fault 7: 318.7 ms of fp32 products a
  frame on the H100);
- softmax attention computed in plain products, where the published
  configuration asks for xformers' memory-efficient attention (``xattn``,
  the same mathematics);
- inference only: no drop path, no activation checkpointing; ``qkv_bias``,
  ``out_feature``, ``xattn``, ``fpn_in_feature``, ``fpn_norm``,
  ``fpn_square_pad``, ``pretrained`` and ``frozen_blocks`` are accepted and
  ignored.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import detector

LN_EPS = 1e-6
CHUNK_ABOVE = 2048      # queries taken CHUNK at a time above this many
CHUNK = 512


# ---------------------------------------------------------------- tables


def _bicubic_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """``[dst, src]`` matrix of torch's bicubic interpolation along one
    axis (cubic convolution, a = -0.75, half-pixel centres, border
    clamp)."""
    w = np.zeros((dst, src), np.float64)

    def cubic(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    for i in range(dst):
        center = (i + 0.5) * src / dst - 0.5
        b = math.floor(center)
        frac = center - b
        for k in (-1, 0, 1, 2):
            w[i, min(max(b + k, 0), src - 1)] += cubic(frac - k)
    return w.astype(np.float32)


def _bicubic_resize(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w, _ = x.shape
    my = _bicubic_matrix(h, size[0]).astype(np.float64)
    mx = _bicubic_matrix(w, size[1]).astype(np.float64)
    return np.einsum("Yh,hwc,Xw->YXc", my, x.astype(np.float64), mx
                     ).astype(np.float32)


def build_rope_tables(head_dim: int, pt_seq_len: int, ft_seq_len: int,
                      theta: float = 10000.0,
                      real_img_size: Optional[Tuple[int, int]] = None):
    """(cos, sin) ``[N, head_dim]`` fp32: EVA-02's 2D RoPE over a square
    ``ft_seq_len`` grid, bicubically resized to ``real_img_size``."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    t = np.arange(ft_seq_len) / ft_seq_len * pt_seq_len
    f = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)
    grid = np.concatenate([
        np.broadcast_to(f[:, None, :], (ft_seq_len, ft_seq_len, f.shape[-1])),
        np.broadcast_to(f[None, :, :], (ft_seq_len, ft_seq_len, f.shape[-1])),
    ], axis=-1)
    cos, sin = np.cos(grid), np.sin(grid)
    if real_img_size is not None:
        cos = _bicubic_resize(cos, real_img_size)
        sin = _bicubic_resize(sin, real_img_size)
    return (cos.reshape(-1, cos.shape[-1]).astype(np.float32),
            sin.reshape(-1, sin.shape[-1]).astype(np.float32))


def _rotate_half(x):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rope(t, cos, sin):
    """t ``[B, N, heads, hd]``; cos / sin ``[N, hd]``."""
    return t * cos[None, :, None, :] + _rotate_half(t) * sin[None, :, None, :]


def attention(q, k, v):
    """Softmax attention of ``[B, N, heads, hd]`` operands (module
    docstring)."""
    n = q.shape[1]
    chunks = [(0, n)] if n <= CHUNK_ABOVE else \
        [(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]
    outs = []
    for a, b in chunks:
        logits = torch.einsum("btnh,bsnh->bnts", q[:, a:b].float(),
                              k.float()) * q.shape[-1] ** -0.5
        probs = torch.softmax(logits, dim=-1).to(k.dtype)
        outs.append(torch.einsum("bnts,bsnh->btnh", probs, v))
    return torch.cat(outs, dim=1)


def window_partition(x, ws: int):
    """``[B, H, W, C]`` -> (``[B * nW, ws, ws, C]``, (Hp, Wp)), zero-padded
    at the bottom and right."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :hw[0], :hw[1]]


# ---------------------------------------------------------------- layers


def _conv_nhwc(x, weight, bias, dtype, stride=1, padding=0):
    """A conv on ``[B, H, W, C]`` in ``dtype`` (None: the input's dtype
    promoted with fp32), the bias added after in that dtype."""
    cd = dtype if dtype is not None else torch.promote_types(x.dtype,
                                                             torch.float32)
    y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), weight.to(cd), None,
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(cd)


class LayerNorm(nn.LayerNorm):
    """LN over the last dim, eps 1e-6, fp32 whatever the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x, dtype=None):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """A channel-last conv in the compute dtype, then its LN (``norm``)."""

    def __init__(self, cin, cout, kernel, bias=True, norm=False):
        super().__init__(cin, cout, kernel, padding=kernel // 2, bias=bias)
        self.norm = LayerNorm(cout) if norm else None

    def forward(self, x, dtype=None):
        x = _conv_nhwc(x, self.weight, self.bias, dtype,
                       stride=self.stride, padding=self.padding)
        return x if self.norm is None else self.norm(x)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2x2 stride-2 deconv, channel-last, in the compute dtype, the bias
    added after."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x, dtype=None):
        cd = dtype if dtype is not None else torch.promote_types(
            x.dtype, torch.float32)
        y = F.conv_transpose2d(x.to(cd).permute(0, 3, 1, 2),
                               self.weight.to(cd), None, stride=2)
        return y.permute(0, 2, 3, 1) + self.bias.to(cd)


class GELU(nn.Module):
    def forward(self, x, dtype=None):
        return F.gelu(x)


class MaxPool2x2(nn.Module):
    def forward(self, x, dtype=None):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class SwiGLU(nn.Module):
    """``w3(ffn_ln(silu(w1 x) * w2 x))``."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.ffn_ln = LayerNorm(hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class EvaAttention(nn.Module):
    """q / k / v projections (q and v with a bias), RoPE on q and k,
    :func:`attention`, ``proj``."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, cos, sin):
        b, h, w, c = x.shape
        n, heads = h * w, self.num_heads
        x = x.reshape(b, n, c)
        q = F.linear(x, self.q_proj.weight, self.q_bias)
        k = F.linear(x, self.k_proj.weight)
        v = F.linear(x, self.v_proj.weight, self.v_bias)
        q = q.reshape(b, n, heads, c // heads)
        k = k.reshape(b, n, heads, c // heads)
        v = v.reshape(b, n, heads, c // heads)
        q = apply_rope(q, cos, sin).to(v.dtype)
        k = apply_rope(k, cos, sin).to(v.dtype)
        return self.proj(attention(q, k, v).reshape(b, n, c)).reshape(
            b, h, w, c)


class ResBottleneckBlock(nn.Module):
    """ViTDet's conv block (1x1, 3x3, 1x1 convs without bias, each followed
    by LN, the first two by exact GELU) added to its input."""

    def __init__(self, dim):
        super().__init__()
        mid = dim // 2
        self.conv1 = nn.Conv2d(dim, mid, 1, bias=False)
        self.norm1 = LayerNorm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.norm2 = LayerNorm(mid)
        self.conv3 = nn.Conv2d(mid, dim, 1, bias=False)
        self.norm3 = LayerNorm(dim)

    def forward(self, x):
        out = F.gelu(self.norm1(_conv_nhwc(x, self.conv1.weight, None, None)))
        out = F.gelu(self.norm2(_conv_nhwc(out, self.conv2.weight, None, None,
                                           padding=1)))
        return x + self.norm3(_conv_nhwc(out, self.conv3.weight, None, None))


class EvaBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, window_size=0,
                 use_residual_block=False):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = EvaAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwiGLU(dim, int(dim * mlp_ratio))
        self.residual = ResBottleneckBlock(dim) if use_residual_block \
            else None

    def forward(self, x, cos, sin):
        y = self.norm1(x)
        if self.window_size > 0:
            hw = (y.shape[1], y.shape[2])
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y, cos, sin)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, hw)
        x = x + y
        x = x + self.mlp(self.norm2(x))
        return x if self.residual is None else self.residual(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, in_chans, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x, dtype):
        return _conv_nhwc(x, self.proj.weight, self.proj.bias, dtype,
                          stride=self.proj.stride)


class ViT(nn.Module):
    """The trunk: ``[B, H, W, 3]`` in the compute dtype -> ``[B, H/ps,
    W/ps, C]``."""

    def __init__(self, img_size, real_img_size, patch_size, in_chans,
                 embed_dim, depth, num_heads, mlp_ratio, use_abs_pos,
                 pt_hw_seq_len, intp_freq, window_size, window_block_indexes,
                 residual_block_indexes, pretrain_img_size,
                 pretrain_use_cls_token):
        super().__init__()
        ps = patch_size
        self.patch_embed = PatchEmbed(ps, in_chans, embed_dim)
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.pos_embed = None
        if use_abs_pos:
            n_pos = ((pretrain_img_size // ps) ** 2
                     + int(pretrain_use_cls_token))
            self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        self.window_block_indexes = tuple(window_block_indexes)
        hd = embed_dim // num_heads // 2 * 2
        real_hw = (real_img_size[0] // ps, real_img_size[1] // ps)
        self._rope_tables = dict(
            win=build_rope_tables(hd, pt_hw_seq_len,
                                  window_size if intp_freq else pt_hw_seq_len),
            glb=build_rope_tables(hd, pt_hw_seq_len,
                                  img_size // ps if intp_freq
                                  else pt_hw_seq_len,
                                  real_img_size=real_hw))
        self._rope: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.blocks = nn.ModuleList([
            EvaBlock(embed_dim, num_heads, mlp_ratio,
                     window_size=(window_size
                                  if i in self.window_block_indexes else 0),
                     use_residual_block=i in residual_block_indexes)
            for i in range(depth)])

    def rope(self, name, device, dtype):
        """(cos, sin) on ``device``: the fp32 tables moved, then cast."""
        key = (name, torch.device(device), dtype)
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(t).to(device).to(dtype)
                                    for t in self._rope_tables[name])
        return self._rope[key]

    def _abs_pos(self, h, w):
        pos = self.pos_embed
        if self.pretrain_use_cls_token:
            pos = pos[:, 1:]
        size = math.isqrt(pos.shape[1])
        pos = pos.reshape(1, size, size, -1)
        if (size, size) == (h, w):
            return pos
        my, mx = (torch.from_numpy(_bicubic_matrix(size, d)).to(pos.device)
                  for d in (h, w))
        return torch.einsum("hs,bstc,wt->bhwc", my, pos, mx)

    def forward(self, x, dtype):
        x = self.patch_embed(x, dtype)
        if self.pos_embed is not None:
            x = x + self._abs_pos(x.shape[1], x.shape[2]).to(x.dtype)
        for i, blk in enumerate(self.blocks):
            name = "win" if i in self.window_block_indexes else "glb"
            cos, sin = self.rope(name, x.device, x.dtype)
            x = blk(x, cos, sin)
        return x


_STAGE_OF_SCALE = {4.0: 2, 2.0: 3, 1.0: 4, 0.5: 5}


class EVA02(nn.Module):
    """The trunk (``net``) and the pyramid (``simfp_{2,3,4,5}``): takes the
    detector's NCHW view of ``[B, H, W, 3]`` images and returns the
    p2..p6 pyramid as NCHW views of channel-last fp32 maps."""

    def __init__(self, img_size: int = 1024,
                 real_img_size: Tuple[int, int] = (256, 704),
                 patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4 * 2 / 3, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, use_abs_pos: bool = True,
                 pt_hw_seq_len: int = 16, intp_freq: bool = True,
                 window_size: int = 0,
                 window_block_indexes: Sequence[int] = (),
                 residual_block_indexes: Sequence[int] = (),
                 use_act_checkpoint: bool = False,
                 pretrain_img_size: int = 224,
                 pretrain_use_cls_token: bool = True,
                 out_feature: str = "last_feat", xattn: bool = False,
                 frozen_blocks: int = -1, fpn_in_feature: str = "last_feat",
                 fpn_out_channels: int = 256,
                 fpn_scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                 fpn_top_block: bool = False, fpn_norm: str = "LN",
                 fpn_square_pad: int = 0, pretrained: Optional[str] = None):
        super().__init__()
        dim, out = embed_dim, fpn_out_channels
        self.stage_names = []
        for scale in map(float, fpn_scale_factors):
            if scale == 4.0:
                layers = [ConvTranspose2d(dim, dim // 2), LayerNorm(dim // 2),
                          GELU(), ConvTranspose2d(dim // 2, dim // 4)]
                cin = dim // 4
            elif scale == 2.0:
                layers, cin = [ConvTranspose2d(dim, dim // 2)], dim // 2
            elif scale == 1.0:
                layers, cin = [], dim
            elif scale == 0.5:
                layers, cin = [MaxPool2x2()], dim
            else:
                raise NotImplementedError(f"scale {scale}")
            layers += [Conv2d(cin, out, 1, bias=False, norm=True),
                       Conv2d(out, out, 3, bias=False, norm=True)]
            name = f"simfp_{_STAGE_OF_SCALE[scale]}"
            self.add_module(name, nn.Sequential(*layers))
            self.stage_names.append(name)
        self.top_block = fpn_top_block
        self.net = ViT(img_size, real_img_size, patch_size, in_chans,
                       embed_dim, depth, num_heads, mlp_ratio, use_abs_pos,
                       pt_hw_seq_len, intp_freq, window_size,
                       window_block_indexes, residual_block_indexes,
                       pretrain_img_size, pretrain_use_cls_token)

    def forward(self, x):
        dtype = x.dtype         # the detector's compute dtype
        feat = self.net(x.permute(0, 2, 3, 1), dtype)
        outs = []
        for name in self.stage_names:
            y = feat
            for layer in getattr(self, name):
                y = layer(y, dtype)
            outs.append(y)
        if self.top_block:
            outs.append(outs[-1][:, ::2, ::2])
        return [f.permute(0, 3, 1, 2) for f in outs]


detector._BACKBONES["EVA02"] = EVA02
