"""Query-sharded (tensor-parallel) decoding over a process group
(counterpart of ``sparsebev_tpu/parallel/query_parallel.py``).

The decoder's sampling, mixing, FFN and branches are per query, so the
query axis splits over the ranks of a ``"q"`` group: each rank runs its own
query range through every layer and reads only its queries' sampling
points. The one cross-query step is the scale-adaptive self-attention
(SASA), which needs every query's box centre and attention keys and values:
:class:`QueryShard` all-gathers them each layer, and the head all-gathers
the ``[L, B, Q, D]`` predictions at the end (:func:`constrain_preds`), so
the decode and the matcher see all queries. The JAX package gets the same
partition from GSPMD by constraining the predictions' sharding; here the
split and the gathers are explicit. The query count need not divide the
group: ranges are split as ``torch.tensor_split`` splits them (no padding
of the model's queries; the collectives pad internally).

Gradients (training with a q group): the keys / values and centres that a
rank gathers feed every rank's attention, so their gather's backward sums
the gradient over the group. The predictions' gather is different: every
q rank computes the same loss on the same gathered predictions, so the
gradient each rank receives for the gathered predictions is identical, and
summing it over the group would count each shard's gradient ``sp`` times.
Its backward therefore keeps this rank's slice alone, and each rank's
parameter gradients are its shard's part of the whole; the train step sums
them over the ranks (``train/step.py``), which counts each once.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import all_gather_cat, all_reduce_sum, rank, shard_range, world_size

QUERY_AXIS = "q"


class _GatherQueries(torch.autograd.Function):
    """All-gather along ``dim``; the backward sums the gradient over the
    group (``sum_grads``) or keeps this rank's slice of it."""

    @staticmethod
    def forward(ctx, t, shard, dim, sum_grads):
        ctx.shard, ctx.dim, ctx.sum_grads = shard, dim, sum_grads
        return all_gather_cat(t, shard.sizes, dim, shard.group)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        if ctx.sum_grads:
            grad = all_reduce_sum(grad.contiguous().clone(), shard.group)
        return grad.narrow(ctx.dim, shard.lo, shard.hi - shard.lo), None, \
            None, None


class QueryShard:
    """This rank's queries ``[lo, hi)`` of ``total`` over ``group`` (what a
    query-sharded head hands its decoder); :meth:`gather` puts the group's
    shards back together."""

    def __init__(self, group, total: int):
        self.group, self.total = group, total
        n = world_size(group)
        self.sizes = [hi - lo for lo, hi in (shard_range(total, i, n)
                                             for i in range(n))]
        self.lo, self.hi = shard_range(total, rank(group), n)

    def gather(self, t: torch.Tensor, dim: int,
               sum_grads: bool = True) -> torch.Tensor:
        """Every rank's shard along ``dim``, in query order. Autograd-aware
        (see the module docstring for ``sum_grads``)."""
        if torch.is_grad_enabled() and t.requires_grad:
            return _GatherQueries.apply(t, self, dim, sum_grads)
        return all_gather_cat(t, self.sizes, dim, self.group)


def constrain_preds(preds: dict, shard: Optional[QueryShard]) -> dict:
    """Gather every ``[L, B, Q_rank, D]`` prediction of a sharded head to
    ``[L, B, total, D]`` (the JAX ``constrain_preds`` pins the same tensors
    to the query sharding). The gradient of each gathered prediction keeps
    this rank's slice (module docstring). No-op without a shard."""
    if shard is None:
        return preds
    return {k: shard.gather(v, 2, sum_grads=False) for k, v in preds.items()}
