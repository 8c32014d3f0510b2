"""Neural building blocks (counterpart of ``sparsebev_tpu/models/layers.py``).

Parameters stay fp32, as in the JAX package; a module given a bf16 input
computes in bf16 with its weights cast to bf16 (the flax ``dtype=``
semantics). LayerNorm statistics and affine stay fp32 and the result is
cast back to the input dtype. Attention logits and softmax are fp32.

Casts of parameters are cached per module and rebuilt when a parameter
changes (its storage or its in-place version counter). The cache serves
inference only: while autograd records and the parameter requires grad, the
cast is computed inside the graph, uncached, so that the gradient reaches
the fp32 parameter.

Dropout (the four sites of the JAX layers: attention weights, attention
output, and after each FFN linear, all p = 0.1) is decided per call by an
explicit ``deterministic`` argument, as in the JAX package, and not by the
module's ``training`` flag: the same module objects serve the streaming
path and the training step, and ``.train()`` / ``.eval()`` must not be able
to change inference bits behind the caller's back. Draws come from an
explicit ``torch.Generator`` (``Dropout.generator``, set for a whole model by
:func:`set_dropout_generator`) so that a step is reproducible from its
seed; without one they come from the device's global generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class CastCache:
    """Parameter casts computed once and reused until the parameter changes."""

    def __init__(self):
        self._cache: Dict[str, Tuple[tuple, torch.Tensor]] = {}

    def get(self, name: str, t: Optional[torch.Tensor], dtype: torch.dtype):
        if t is None or t.dtype == dtype:
            return t
        if t.requires_grad and torch.is_grad_enabled():
            return t.to(dtype)          # in the graph: the parameter trains
        key = (dtype, t.device, t.data_ptr(), t._version)
        hit = self._cache.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, t.detach().to(dtype))
            self._cache[name] = hit
        return hit[1]


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._casts = CastCache()

    def forward(self, x):
        return F.linear(x, self._casts.get("weight", self.weight, x.dtype),
                        self._casts.get("bias", self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with fp32 statistics and affine; returns
    the input dtype."""

    def __init__(self, normalized_shape, eps: float = 1e-5):
        super().__init__(normalized_shape, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout with an explicit switch and an explicit generator
    (see the module docstring): ``x * mask / (1 - p)`` with ``mask`` ~
    Bernoulli(1 - p), the identity when ``deterministic``."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x, deterministic: bool = True):
        if deterministic or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return x * mask.to(x.dtype) / keep


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` under ``module`` at ``generator`` (on the
    tensors' device; ``None`` returns them to the global generator)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def dropout_generator(module: nn.Module) -> Optional[torch.Generator]:
    """The one generator the :class:`Dropout` modules under ``module`` draw
    from (None: the global generator)."""
    gens = {id(m.generator): m.generator for m in module.modules()
            if isinstance(m, Dropout)}
    if len(gens) > 1:
        raise ValueError("the dropout sites draw from more than one "
                         "generator (see set_dropout_generator)")
    return next(iter(gens.values()), None)


def checkpoint_with_generator(fn, *args, generator=None):
    """``fn(*args)`` as a non-reentrant ``torch.utils.checkpoint`` region
    whose recompute draws what its first run drew. ``torch.utils.checkpoint``
    restores only the default generators; a region that draws from an
    explicit ``generator`` (the dropout of a training step) is replayed with
    that generator's state at the first run, which is put back afterwards,
    so the masks and every later draw stay as they were."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    state = generator.get_state()
    ran = []

    def run(*a):
        if not ran:
            ran.append(True)
            return fn(*a)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class _AttentionCore(nn.Module):
    """torch nn.MultiheadAttention's parameters (packed ``in_proj``, ``out_proj``)."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = Linear(embed_dims, embed_dims)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self._casts = CastCache()


class MultiheadAttention(nn.Module):
    """mmcv MultiheadAttention (batch-first): packed qkv projection, a mask
    ``[B*H, Q, K]`` on the fp32 logits (additive float, or bool with True =
    blocked -> ``-inf``), fp32 softmax, dropout on the attention weights and
    on the projected output, and the residual ``query + attn_out``."""

    def __init__(self, embed_dims: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.attn = _AttentionCore(embed_dims)
        self.attn_drop = Dropout(dropout)
        self.proj_drop = Dropout(dropout)

    def forward(self, query, attn_mask=None, deterministic: bool = True):
        c, h = self.embed_dims, self.num_heads
        hd = c // h
        b, q_len, _ = query.shape
        core = self.attn
        w = core._casts.get("in_proj_weight", core.in_proj_weight, query.dtype)
        bias = core._casts.get("in_proj_bias", core.in_proj_bias, query.dtype)
        qkv = F.linear(query, w, bias)                        # [B, Q, 3C]
        qh, kh, vh = (t.reshape(b, q_len, h, hd).transpose(1, 2)
                      for t in qkv.split(c, dim=-1))          # [B, H, Q, hd]
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                bias = torch.zeros(attn_mask.shape, dtype=logits.dtype,
                                   device=logits.device).masked_fill(
                                       attn_mask, float("-inf"))
            else:
                bias = attn_mask.float()
            logits = logits + bias.reshape(b, h, q_len, q_len)
        attn = self.attn_drop(torch.softmax(logits, dim=-1), deterministic)
        out = torch.matmul(attn.to(query.dtype), vh)          # [B, H, Q, hd]
        out = out.transpose(1, 2).reshape(b, q_len, c)
        return query + self.proj_drop(core.out_proj(out), deterministic)


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> drop -> Linear -> drop, plus the residual
    (keys ``layers.0.0`` and ``layers.1``)."""

    def __init__(self, embed_dims: int, feedforward_channels: int = 512,
                 ffn_drop: float = 0.1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dims, feedforward_channels), nn.ReLU()),
            Linear(feedforward_channels, embed_dims))
        self.drop1 = Dropout(ffn_drop)
        self.drop2 = Dropout(ffn_drop)

    def forward(self, x, deterministic: bool = True):
        y = self.drop1(self.layers[0](x), deterministic)
        y = self.drop2(self.layers[1](y), deterministic)
        return x + y
