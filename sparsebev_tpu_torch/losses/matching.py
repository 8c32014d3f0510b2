"""Hungarian matching (counterpart of ``sparsebev_tpu/losses/matching.py``).

The JAX package solves the assignment on the device with a ``while_loop``
Jonker-Volgenant so that the step stays one XLA program. An eager PyTorch
step has no such constraint, and the assignment is a branchy scalar
algorithm that a GPU does badly, so the port solves it on the host with
scipy's ``linear_sum_assignment`` (the reference model's own solver). The
two agree on every cost matrix whose optimum is unique. The transfer
synchronizes the device, so callers hand over ALL their cost matrices in one
call (the detection loss: every decoder layer's), which makes it one
round trip a step; the matching reads detached predictions only.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils import tracing

_PAD_COST = 1e6


@torch.no_grad()
def hungarian_matching(cost: torch.Tensor,
                       gt_mask: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment, batched over the leading dims.

    cost ``[..., M, Q]`` (rows = ground truth, columns = queries, M <= Q);
    gt_mask ``[..., M]`` bool (broadcast over extra leading dims of
    ``cost``). Returns the query index assigned to each ground-truth row,
    ``[..., M]`` int64 on ``cost``'s device; rows with ``~gt_mask`` get a
    constant cost, so they never change the real rows' optimum, and their
    entries are to be masked by the caller."""
    with tracing.span("train.matcher"):
        cost = torch.nan_to_num(cost.detach().float(), nan=100.0,
                                posinf=100.0, neginf=-100.0)
        mask = gt_mask.expand(cost.shape[:-1])
        cost = torch.where(mask[..., None], cost,
                           torch.full_like(cost, _PAD_COST))
        host = cost.cpu().numpy()                  # the one transfer
        flat = host.reshape((-1,) + host.shape[-2:])
        out = np.zeros(flat.shape[:2], np.int64)
        for i, c in enumerate(flat):
            rows, cols = linear_sum_assignment(c)
            out[i, rows] = cols
        return torch.from_numpy(out.reshape(host.shape[:-1])).to(cost.device)
