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
seed; without one they come from the device's global generator. The EVA02
backbone's stochastic depth (:class:`DropPath`) follows the same rules.
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

    def forward(self, x, deterministic: bool = True, queries=None,
                dim: int = 1):
        """``queries`` (a query-sharded head's ``QueryShard``, ``x`` holding
        its rows along ``dim``): the mask is drawn for every query and this
        rank's rows are kept, so each rank applies the unsharded run's
        mask."""
        if deterministic or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        shape = list(x.shape)
        if queries is not None:
            shape[dim] = queries.total
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        if queries is not None:
            mask = mask.narrow(dim, queries.lo, x.shape[dim])
        return x * mask.to(x.dtype) / keep


class DropPath(nn.Module):
    """Stochastic depth on the batch dim (``sparsebev_tpu/models/eva02.py::
    drop_path``): one Bernoulli(1 - ``rate``) draw a sample, ``x * mask /
    (1 - rate)``; the identity when ``deterministic`` or at rate 0 (no
    draw). Draws come from ``generator`` (see :func:`set_dropout_generator`)
    unless ``draws`` is set (:func:`set_drop_path_draws`): then
    ``draws(block, site, batch)`` returns the ``[batch]`` mask (bool or 0/1)
    of this site, ``block`` and ``site`` given at construction."""

    def __init__(self, rate: float = 0.0, block: int = 0, site: int = 0):
        super().__init__()
        self.rate = float(rate)
        self.block = block
        self.site = site
        self.generator: Optional[torch.Generator] = None
        self.draws = None

    def forward(self, x, deterministic: bool = True):
        if deterministic or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        n = x.shape[0]
        if self.draws is not None:
            mask = torch.as_tensor(self.draws(self.block, self.site, n),
                                   device=x.device)
        else:
            mask = torch.rand((n,), generator=self.generator,
                              device=x.device) < keep
        mask = mask.to(x.dtype).reshape((n,) + (1,) * (x.dim() - 1))
        return x * mask / keep


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` and :class:`DropPath` under ``module``
    at ``generator`` (on the tensors' device; ``None`` returns them to the
    global generator)."""
    for m in module.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.generator = generator


def set_drop_path_draws(module: nn.Module, draws) -> None:
    """Give every :class:`DropPath` under ``module`` the mask function
    ``draws(block, site, batch)`` in place of its generator's draws (None:
    draw)."""
    for m in module.modules():
        if isinstance(m, DropPath):
            m.draws = draws


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

    def forward(self, query, attn_mask=None, deterministic: bool = True,
                queries=None):
        """``queries`` (a query-sharded head's ``QueryShard``): ``query``
        holds this rank's rows, which attend over every rank's keys and
        values (gathered); ``attn_mask`` is then ``[B*H, Q_rank, K]``."""
        c, h = self.embed_dims, self.num_heads
        hd = c // h
        b, q_len, _ = query.shape
        core = self.attn
        w = core._casts.get("in_proj_weight", core.in_proj_weight, query.dtype)
        bias = core._casts.get("in_proj_bias", core.in_proj_bias, query.dtype)
        qkv = F.linear(query, w, bias)                        # [B, Q, 3C]
        qh, kh, vh = (t.reshape(b, q_len, h, hd).transpose(1, 2)
                      for t in qkv.split(c, dim=-1))          # [B, H, Q, hd]
        if queries is not None:
            kh, vh = queries.gather(kh, 2), queries.gather(vh, 2)  # K rows
        k_len = kh.shape[2]
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                bias = torch.zeros(attn_mask.shape, dtype=logits.dtype,
                                   device=logits.device).masked_fill(
                                       attn_mask, float("-inf"))
            else:
                bias = attn_mask.float()
            logits = logits + bias.reshape(b, h, q_len, k_len)
        attn = self.attn_drop(torch.softmax(logits, dim=-1), deterministic,
                              queries, dim=2)
        out = torch.matmul(attn.to(query.dtype), vh)          # [B, H, Q, hd]
        out = out.transpose(1, 2).reshape(b, q_len, c)
        return query + self.proj_drop(core.out_proj(out), deterministic,
                                      queries)


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

    def forward(self, x, deterministic: bool = True, queries=None):
        y = self.drop1(self.layers[0](x), deterministic, queries)
        y = self.drop2(self.layers[1](y), deterministic, queries)
        return x + y
