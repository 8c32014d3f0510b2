"""Process groups for data parallelism (counterpart of
``sparsebev_tpu/parallel/mesh.py``).

The JAX package shards the batch over a device mesh and lets XLA insert the
collectives; here every rank is a process with one card (NCCL) or the CPU
(gloo), and the collectives are explicit. The mesh functions become process
groups: :func:`make_group` (the JAX ``make_mesh``),
:func:`make_group_for_batch` (``make_mesh_for_batch``: the first ranks, as
many as divide the global batch) and :func:`make_hybrid_groups`
(``make_hybrid_mesh``: dp x sp, a ``"data"`` group of the ranks that share
a query range and a ``"q"`` group of the ranks that share a batch shard).
:func:`shard_batch` takes a rank's slice of a batch and
:func:`gather_results` brings per-rank results to rank 0.

Every multi-rank function takes its group explicitly (None: the default
group); nothing but the default group is global state. A gloo group takes
no CUDA tensor for most collectives, so the helpers here stage a CUDA
tensor's collective through host memory when the group is gloo (the
kernels still run on the card; only the collective's bytes go through the
host).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it fails
INIT_TIMEOUT = datetime.timedelta(seconds=1800)


def init_from_env(device: Optional[torch.device] = None) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``): NCCL when ``device`` is a card, gloo on the CPU. The
    counterpart of ``jax.distributed.initialize`` (the JAX train CLI's
    ``--multihost``). Returns the rank's device: ``cuda:LOCAL_RANK`` on a
    card, the CPU otherwise."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs the torchrun environment; "
                           f"{', '.join(missing)} not set")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://",
            timeout=INIT_TIMEOUT)
    return device


def world_size(group=None) -> int:
    """Ranks in ``group`` (1 without a process group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def is_main_process() -> bool:
    """Rank 0 of the default group, or the one process: it logs, writes
    checkpoints and keeps the evaluation's results."""
    return rank() == 0


def make_group(ranks: Sequence[int]):
    """A group of ``ranks`` (all of them: the default group,
    ``dist.group.WORLD``). Every rank of the default group must call it, in
    the same order."""
    if len(ranks) == world_size():
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_group_for_batch(batch_size: int):
    """The data group of a global batch (the JAX ``make_mesh_for_batch``):
    the first ``n`` ranks, ``n`` the largest divisor of ``batch_size`` that
    is at most the world, so that the batch shards evenly. Returns ``(group,
    n)``. Every rank must call it; a rank ``>= n`` is no member of the
    group and takes no part in the run (its caller leaves)."""
    n = max(d for d in range(1, world_size() + 1) if batch_size % d == 0)
    return make_group(range(n)), n


@dataclass
class HybridGroups:
    """dp x sp ranks, rank = d * sp + s (the JAX hybrid mesh's
    ``devices.reshape(dp, sp)``): ``data`` holds the ranks of query index
    ``s`` (the batch shards over it, the loss normalizers sum over it),
    ``q`` the ranks of data index ``d`` (one batch shard, its queries split
    over them). ``data_index`` / ``q_index`` are this rank's."""
    dp: int
    sp: int
    data: Any
    q: Any
    data_index: int
    q_index: int


def make_hybrid_groups(dp: int, sp: int) -> HybridGroups:
    """The dp x sp groups over the default group (which must hold exactly
    dp * sp ranks). Every rank creates every group, in the same order."""
    n = world_size()
    if dp * sp != n:
        raise ValueError(f"dp*sp={dp * sp} does not match {n} ranks")
    me = rank()
    data_groups = [make_group(range(s, n, sp)) for s in range(sp)]
    q_groups = [make_group(range(d * sp, (d + 1) * sp)) for d in range(dp)]
    d, s = divmod(me, sp)
    return HybridGroups(dp, sp, data_groups[s], q_groups[d], d, s)


def shard_range(count: int, index: int, shards: int):
    """``(lo, hi)`` of shard ``index`` of ``count`` items split as
    ``torch.tensor_split`` splits them (the first ``count % shards`` shards
    one longer)."""
    base, extra = divmod(count, shards)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def shard_batch(batch: Any, index: int, shards: int) -> Any:
    """Shard ``index`` of ``shards`` of every array or tensor in ``batch``
    along its leading (batch) dim (lists are kept whole)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, index, shards) for k, v in batch.items()}
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        n = batch.shape[0]
        if n % shards:
            raise ValueError(f"a batch of {n} does not shard over {shards}")
        per = n // shards
        return batch[index * per:(index + 1) * per]
    return batch


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; a no-op on one rank."""
    if world_size(group) > 1:
        dist.barrier(group=group)


def gather_results(obj: Any, group=None) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order on rank 0 of ``group`` (None on
    the others; ``[obj]`` without a process group). The counterpart of the
    JAX ``gather_results`` (the reference's ``gpu_collect``)."""
    if world_size(group) == 1:
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out if rank(group) == 0 else None


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group``, in place (returned); a no-op on one
    rank."""
    if world_size(group) == 1:
        return t
    if _through_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, sizes: Sequence[int], dim: int,
                   group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order; rank i's
    ``t`` holds ``sizes[i]`` entries along ``dim`` (padded to the largest
    for the collective, which takes one size)."""
    n = world_size(group)
    if n == 1:
        return t
    longest = max(sizes)
    dim = dim % t.dim()
    if t.shape[dim] < longest:
        pad = list(t.shape)
        pad[dim] = longest - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    t = t.contiguous()
    staged = _through_host(t, group)
    src = t.cpu() if staged else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                    dim=dim)
    return out.to(t.device) if staged else out
