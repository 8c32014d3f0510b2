"""EVA02 ViT backbone with the ViTDet SimpleFeaturePyramid (counterpart of
``sparsebev_tpu/models/eva02.py``): a plain ViT with an interpolated
absolute position embedding, 2D rotary embeddings with bicubic frequency
interpolation to the real aspect ratio, a SwiGLU MLP with sub-LN, windowed
attention on most blocks and global attention on the rest, and the
deconv / identity / max-pool pyramid off the last feature with an optional
stride-2 top level.

Module names are the reference's detectron2 state-dict keys (``net.*`` for
the trunk, ``simfp_{2,3,4,5}.{j}`` for the pyramid stages in their
Sequential indices, each 1x1 / 3x3 conv with its ``.norm``), so this module
is the inverse of the JAX package's ``utils/checkpoint_io.py::_port_eva02``.
Activations are channel-last ``[B, H, W, C]`` inside, as in JAX; the
module takes and returns NCHW views like the port's other backbones.

The dtype flow is the JAX module's under a bf16 compute dtype (``dtype``):
its ``Linear`` and ``LayerNorm`` take ``dtype=None`` and flax promotes a bf16
input against the fp32 parameters, so

- the patch embed and the absolute position add run in ``dtype``;
- every LayerNorm returns fp32, so from block 0's ``norm1`` on the trunk
  (q / k / v, attention, SwiGLU, block outputs) is fp32, and block 0's
  residual add promotes its ``dtype`` shortcut;
- the RoPE tables are cast to the running activation's dtype at each block
  (``ViT.__call__`` :366): block 0 multiplies by ``dtype``-rounded tables;
- the pyramid's (de)convolutions compute in ``dtype``, each LN after them
  in fp32; its outputs are fp32 (the detector casts them).

The attention goes through ``ops/eva_attention.py`` (a kernel on the card).
The projections and SwiGLU matrices go through ``ops/eva_linear.py``: fp32
products, as JAX leaves them to XLA; ``F.linear`` on the CPU, a 3xTF32
tensor-core kernel on the card (fp32-level accuracy, not TF32's).
Window padding is zeros after ``norm1``, and the padded tokens take part in
the attention unmasked (k = 0, q = the rotated q bias, v = the v bias), as
in JAX.

Training follows ``ViT.__call__(x, deterministic)``: with ``deterministic``
False each block applies stochastic depth (``models/layers.py::DropPath``)
after its attention branch and after its MLP branch, at the block's rate
from ``np.linspace(0, drop_path_rate, depth)`` (block 0 draws nothing), one
draw a sample from the step's generator; with ``use_act_checkpoint`` and
gradients enabled each block is a checkpointed region
(``layers.py::checkpoint_with_generator``, JAX's
``nn.remat(EvaBlock)``), whose recompute replays the block's masks. Frozen
blocks still get gradients: the optimizer gives them lr 0
(``train/optim.py::eva02_frozen_patterns``), as JAX masks its updates.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.eva_attention import eva_attention
from ..ops.eva_linear import eva_linear
from ..utils import tracing
from .layers import DropPath, checkpoint_with_generator

LN_EPS = 1e-6


# ---------------------------------------------------------------------------
# 2D RoPE and the bicubic resize (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _bicubic_resize(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """torch ``F.interpolate(mode='bicubic', align_corners=False)`` of an
    ``[h, w, c]`` array in numpy, through the separable
    :func:`_bicubic_matrix` (the RoPE tables' aspect resize)."""
    h, w, _ = x.shape
    my = _bicubic_matrix(h, size[0]).astype(np.float64)
    mx = _bicubic_matrix(w, size[1]).astype(np.float64)
    return np.einsum("Yh,hwc,Xw->YXc", my, x.astype(np.float64), mx
                     ).astype(np.float32)


def build_rope_tables(head_dim: int, pt_seq_len: int, ft_seq_len: int,
                      theta: float = 10000.0,
                      real_img_size: Optional[Tuple[int, int]] = None):
    """(cos, sin) of shape ``[N, head_dim]``, N = ft_h * ft_w (square
    ``ft_seq_len`` unless ``real_img_size`` is given)."""
    dim = head_dim // 2  # the reference passes half_head_dim
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    t = np.arange(ft_seq_len) / ft_seq_len * pt_seq_len
    f = np.einsum("i,j->ij", t, freqs)          # [seq, dim//2]
    f = np.repeat(f, 2, axis=-1)                # [seq, dim]
    grid = np.concatenate([
        np.broadcast_to(f[:, None, :], (ft_seq_len, ft_seq_len, f.shape[-1])),
        np.broadcast_to(f[None, :, :], (ft_seq_len, ft_seq_len, f.shape[-1])),
    ], axis=-1)
    cos = np.cos(grid)
    sin = np.sin(grid)
    if real_img_size is not None:
        cos = _bicubic_resize(cos, real_img_size)
        sin = _bicubic_resize(sin, real_img_size)
    return (cos.reshape(-1, cos.shape[-1]).astype(np.float32),
            sin.reshape(-1, sin.shape[-1]).astype(np.float32))


def _bicubic_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """``[dst, src]`` matrix of torch's bicubic interpolation along one axis
    (cubic convolution with a = -0.75, half-pixel centres, border clamp)."""
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


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(even, odd) channel pairs -> (-odd, even)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rope(t: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """t: ``[B, N, heads, head_dim]``; cos / sin: ``[N, head_dim]``."""
    return t * cos[None, :, None, :] + _rotate_half(t) * sin[None, :, None, :]


def window_partition(x: torch.Tensor, ws: int):
    """``[B, H, W, C]`` -> (``[B * nW, ws, ws, C]``, padded (Hp, Wp)); the
    padding is zeros at the bottom and right."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


# ---------------------------------------------------------------------------
# channel-last layers with the JAX module's dtypes
# ---------------------------------------------------------------------------

def _compute_dtype(dtype, x: torch.Tensor) -> torch.dtype:
    """A flax module's computation dtype: ``dtype``, or (None) its input's
    promoted with the fp32 parameters."""
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               torch.float32)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, eps 1e-6, returning fp32 whatever the
    input dtype (flax ``nn.LayerNorm(dtype=None)`` with fp32 parameters);
    detectron2's channel LN on the pyramid's NCHW maps is the same
    normalisation."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def _conv_nhwc(x, weight, bias, dtype, stride=1, padding=0):
    """flax ``nn.Conv`` on ``[B, H, W, C]`` in ``dtype``: the convolution,
    then the bias added in ``dtype``."""
    cd = _compute_dtype(dtype, x)
    y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), weight.to(cd), None,
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(cd)


class Conv2d(nn.Conv2d):
    """A channel-last conv computing in ``dtype`` (None: promoted);
    ``norm`` (detectron2's ``Conv2d(norm=...)``) runs after it."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True,
                 norm: bool = False, dtype=None):
        super().__init__(cin, cout, kernel, padding=kernel // 2, bias=bias)
        self.norm = LayerNorm(cout) if norm else None
        self.dtype = dtype

    def forward(self, x):
        x = _conv_nhwc(x, self.weight, self.bias, self.dtype,
                       stride=self.stride, padding=self.padding)
        return x if self.norm is None else self.norm(x)


class ConvTranspose2d(nn.ConvTranspose2d):
    """The pyramid's 2x2 stride-2 deconv, channel-last, in ``dtype`` (flax
    ``nn.ConvTranspose(transpose_kernel=True)``, the bias added after)."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__(cin, cout, 2, stride=2)
        self.dtype = dtype

    def forward(self, x):
        cd = _compute_dtype(self.dtype, x)
        y = F.conv_transpose2d(x.to(cd).permute(0, 3, 1, 2),
                               self.weight.to(cd), None, stride=2)
        return y.permute(0, 2, 3, 1) + self.bias.to(cd)


class GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x)        # exact (erf), nn.gelu(approximate=False)


class MaxPool2x2(nn.Module):
    """2x2 stride-2 max pool on ``[B, H, W, C]`` (VALID)."""

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return eva_linear(x, layer.weight, layer.bias)


class SwiGLU(nn.Module):
    """``w3(ffn_ln(silu(w1 x) * w2 x))``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.ffn_ln = LayerNorm(hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = F.silu(_linear(self.w1, x)) * _linear(self.w2, x)
        return _linear(self.w3, self.ffn_ln(h))


class EvaAttention(nn.Module):
    """Separate q / k / v projections (q and v with a bias, k without), RoPE
    on q and k, attention through ``ops/eva_attention.py``, ``proj``.
    ``real_tokens``: in a windowed block, the tokens of its windows that
    are not padding (the op counts them)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope_cos, rope_sin, real_tokens=None):
        b, h, w, c = x.shape
        n, heads = h * w, self.num_heads
        x = x.reshape(b, n, c)
        q = eva_linear(x, self.q_proj.weight, self.q_bias)
        k = eva_linear(x, self.k_proj.weight)
        v = eva_linear(x, self.v_proj.weight, self.v_bias)
        q = q.reshape(b, n, heads, c // heads)
        k = k.reshape(b, n, heads, c // heads)
        v = v.reshape(b, n, heads, c // heads)
        q = apply_rope(q, rope_cos, rope_sin).to(v.dtype)
        k = apply_rope(k, rope_cos, rope_sin).to(v.dtype)
        out = eva_attention(q, k, v, real_tokens=real_tokens)
        return _linear(self.proj, out.reshape(b, n, c)).reshape(b, h, w, c)


class ResBottleneckBlock(nn.Module):
    """ViTDet conv propagation block (1x1, 3x3, 1x1 convs without bias, each
    followed by LN, the first two by exact GELU; ``norm3`` zero-initialised
    in the reference) added to its input."""

    def __init__(self, dim: int):
        super().__init__()
        mid = dim // 2
        self.conv1 = nn.Conv2d(dim, mid, 1, bias=False)
        self.norm1 = LayerNorm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.norm2 = LayerNorm(mid)
        self.conv3 = nn.Conv2d(mid, dim, 1, bias=False)
        self.norm3 = LayerNorm(dim)
        nn.init.zeros_(self.norm3.weight)
        nn.init.zeros_(self.norm3.bias)

    def forward(self, x):
        out = F.gelu(self.norm1(_conv_nhwc(x, self.conv1.weight, None, None)))
        out = F.gelu(self.norm2(_conv_nhwc(out, self.conv2.weight, None, None,
                                           padding=1)))
        out = self.norm3(_conv_nhwc(out, self.conv3.weight, None, None))
        return x + out


class EvaBlock(nn.Module):
    """norm1, (windowed) attention, drop path, residual; norm2, SwiGLU, drop
    path, residual; the optional conv block. ``index`` names the block to
    its two :class:`DropPath` sites (0 after the attention, 1 after the
    MLP). Each call is an ``eva02.window_block`` or ``eva02.global_block``
    span (``utils/tracing.py``; a remat's recompute calls it again)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int = 0, use_residual_block: bool = False,
                 drop_path_rate: float = 0.0, index: int = 0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = EvaAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwiGLU(dim, int(dim * mlp_ratio))
        self.residual = ResBottleneckBlock(dim) if use_residual_block \
            else None
        self.drop_path_attn = DropPath(drop_path_rate, index, 0)
        self.drop_path_mlp = DropPath(drop_path_rate, index, 1)

    def forward(self, x, rope_cos, rope_sin, deterministic: bool = True):
        windowed = self.window_size > 0
        with tracing.span("eva02.window_block" if windowed
                          else "eva02.global_block"):
            shortcut = x
            y = self.norm1(x)
            real = None
            if windowed:
                h, w = y.shape[1], y.shape[2]
                real = y.shape[0] * h * w
                y, pad_hw = window_partition(y, self.window_size)
            y = self.attn(y, rope_cos, rope_sin, real_tokens=real)
            if windowed:
                y = window_unpartition(y, self.window_size, pad_hw, (h, w))
            y = self.drop_path_attn(y, deterministic)
            x = shortcut + y    # a bf16 shortcut + the fp32 branch: fp32
            x = x + self.drop_path_mlp(self.mlp(self.norm2(x)),
                                       deterministic)
            if self.residual is not None:
                x = self.residual(x)
            return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype=None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.dtype = dtype

    def forward(self, x):
        """``[B, H, W, 3]`` -> ``[B, H/ps, W/ps, C]`` in ``dtype``."""
        return _conv_nhwc(x, self.proj.weight, self.proj.bias, self.dtype,
                          stride=self.proj.stride)


class ViT(nn.Module):
    """Plain ViT trunk. Input ``[B, H, W, 3]``, output ``[B, H/ps, W/ps,
    C]``. ``drop_path_rate`` and ``use_act_checkpoint`` act in training
    (``forward(x, deterministic=False)``; see the module docstring); the
    optimizer reads the config's ``frozen_blocks``
    (``train/optim.py::eva02_frozen_patterns``)."""

    def __init__(self, img_size: int = 1024,
                 real_img_size: Tuple[int, int] = (256, 704),
                 patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4 * 2 / 3, drop_path_rate: float = 0.0,
                 use_abs_pos: bool = True, pt_hw_seq_len: int = 16,
                 intp_freq: bool = True, window_size: int = 0,
                 window_block_indexes: Sequence[int] = (),
                 residual_block_indexes: Sequence[int] = (),
                 use_act_checkpoint: bool = False,
                 pretrain_img_size: int = 224,
                 pretrain_use_cls_token: bool = True,
                 frozen_blocks: int = -1, dtype=None):
        super().__init__()
        ps = patch_size
        self.patch_embed = PatchEmbed(ps, in_chans, embed_dim, dtype)
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.pos_embed = None
        if use_abs_pos:
            n_pos = ((pretrain_img_size // ps) ** 2
                     + int(pretrain_use_cls_token))
            self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        self.window_block_indexes = tuple(window_block_indexes)

        half_head = embed_dim // num_heads // 2
        real_hw = (real_img_size[0] // ps, real_img_size[1] // ps)
        # numpy (cos, sin) tables, made on the device at first use
        # (:meth:`rope`): neither parameters nor buffers, so a model built
        # on ``meta`` and given storage by ``to_empty`` computes them alike
        self._rope_tables = dict(
            win=build_rope_tables(half_head * 2, pt_hw_seq_len,
                                  window_size if intp_freq else pt_hw_seq_len),
            glb=build_rope_tables(half_head * 2, pt_hw_seq_len,
                                  img_size // ps if intp_freq
                                  else pt_hw_seq_len,
                                  real_img_size=real_hw))
        self._rope: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.use_act_checkpoint = use_act_checkpoint
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            EvaBlock(embed_dim, num_heads, mlp_ratio,
                     window_size=(window_size
                                  if i in self.window_block_indexes else 0),
                     use_residual_block=i in residual_block_indexes,
                     drop_path_rate=float(dpr[i]), index=i)
            for i in range(depth)])
        self._resize: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _abs_pos(self, h: int, w: int) -> torch.Tensor:
        """The pretrain grid's embedding (cls token dropped), resized to
        ``(h, w)`` with torch's bicubic through two interpolation
        matrices."""
        pos = self.pos_embed
        if self.pretrain_use_cls_token:
            pos = pos[:, 1:]
        size = math.isqrt(pos.shape[1])
        pos = pos.reshape(1, size, size, -1)
        if (size, size) == (h, w):
            return pos
        key = (size, h, w, pos.device)
        mats = self._resize.get(key)
        if mats is None:
            mats = tuple(torch.from_numpy(_bicubic_matrix(size, d)).to(
                pos.device) for d in (h, w))
            self._resize[key] = mats
        return torch.einsum("hs,bstc,wt->bhwc", mats[0], pos, mats[1])

    def rope(self, name: str, device, dtype) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """The ``win`` or ``glb`` RoPE (cos, sin) ``[N, head_dim]`` on
        ``device`` in ``dtype``: the fp32 numpy tables, moved, then cast
        (made once a device and dtype)."""
        key = (name, torch.device(device), dtype)
        tables = self._rope.get(key)
        if tables is None:
            tables = self._rope[key] = tuple(
                torch.from_numpy(t).to(device).to(dtype)
                for t in self._rope_tables[name])
        return tables

    def forward(self, x, deterministic: bool = True):
        x = self.patch_embed(x)
        if self.pos_embed is not None:
            x = x + self._abs_pos(x.shape[1], x.shape[2]).to(x.dtype)
        remat = self.use_act_checkpoint and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            name = "win" if i in self.window_block_indexes else "glb"
            cos, sin = self.rope(name, x.device, x.dtype)
            if remat:
                x = checkpoint_with_generator(
                    blk, x, cos, sin, deterministic,
                    generator=blk.drop_path_attn.generator)
            else:
                x = blk(x, cos, sin, deterministic)
        return x


# detectron2's stage of each pyramid scale (stride = patch / scale, stage =
# log2 stride at patch 16), and the member layout of its Sequential
_STAGE_OF_SCALE = {4.0: 2, 2.0: 3, 1.0: 4, 0.5: 5}


class SimpleFeaturePyramid(nn.Module):
    """ViTDet pyramid off one feature: scale 4 (deconv, LN, GELU, deconv),
    2 (deconv), 1 (the input), 0.5 (max pool), each followed by a 1x1 and a
    3x3 conv with LN; ``top_block`` adds a stride-2 subsample of the last
    output. Stages are ``simfp_{stage}`` Sequentials in the reference's
    indices. Input ``[B, H, W, C]``; outputs ``[B, H', W', out]`` fp32
    (convs in ``dtype``, LNs in fp32)."""

    def __init__(self, in_dim: int, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                 top_block: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.stage_names = []
        for scale in scale_factors:
            scale = float(scale)
            if scale not in _STAGE_OF_SCALE:
                raise NotImplementedError(f"scale {scale}")
            if scale == 4.0:
                layers = [ConvTranspose2d(in_dim, in_dim // 2, dtype),
                          LayerNorm(in_dim // 2), GELU(),
                          ConvTranspose2d(in_dim // 2, in_dim // 4, dtype)]
                cin = in_dim // 4
            elif scale == 2.0:
                layers = [ConvTranspose2d(in_dim, in_dim // 2, dtype)]
                cin = in_dim // 2
            elif scale == 1.0:
                layers = []
                cin = in_dim
            else:
                layers = [MaxPool2x2()]
                cin = in_dim
            layers += [Conv2d(cin, out_channels, 1, bias=False, norm=True,
                              dtype=dtype),
                       Conv2d(out_channels, out_channels, 3, bias=False,
                              norm=True, dtype=dtype)]
            name = f"simfp_{_STAGE_OF_SCALE[scale]}"
            self.add_module(name, nn.Sequential(*layers))
            self.stage_names.append(name)
        self.top_block = top_block

    def forward(self, feat):
        outs = [getattr(self, name)(feat) for name in self.stage_names]
        if self.top_block:
            outs.append(outs[-1][:, ::2, ::2])
        return outs


class EVA02(SimpleFeaturePyramid):
    """The ViT trunk (``net``) and its pyramid (``simfp_*``), as the
    reference's detectron2 ``SimpleFeaturePyramid`` holds them. Takes
    ``[B, 3, H, W]`` (an NCHW view, as the detector gives every backbone)
    and returns the p2..p6 pyramid as NCHW views of channel-last fp32 maps.
    Accepts every field of the JAX dataclass; ``qkv_bias``, ``out_feature``,
    ``xattn``, ``fpn_in_feature``, ``fpn_norm``, ``fpn_square_pad`` and
    ``pretrained`` are ignored there and here. ``deterministic`` (False in
    training) turns the trunk's drop path on. The pyramid is an
    ``eva02.pyramid`` span."""

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
                 fpn_square_pad: int = 0, pretrained: Optional[str] = None,
                 dtype=None):
        super().__init__(embed_dim, fpn_out_channels, fpn_scale_factors,
                         fpn_top_block, dtype)
        self.net = ViT(
            img_size=img_size, real_img_size=real_img_size,
            patch_size=patch_size, in_chans=in_chans, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
            drop_path_rate=drop_path_rate, use_abs_pos=use_abs_pos,
            pt_hw_seq_len=pt_hw_seq_len, intp_freq=intp_freq,
            window_size=window_size,
            window_block_indexes=window_block_indexes,
            residual_block_indexes=residual_block_indexes,
            use_act_checkpoint=use_act_checkpoint,
            pretrain_img_size=pretrain_img_size,
            pretrain_use_cls_token=pretrain_use_cls_token,
            frozen_blocks=frozen_blocks, dtype=dtype)

    def forward(self, x, deterministic: bool = True):
        feat = self.net(x.permute(0, 2, 3, 1), deterministic)
        with tracing.span("eva02.pyramid"):
            feats = super().forward(feat)
        return [f.permute(0, 3, 1, 2) for f in feats]
