"""Plain packs: one pyramid level -> grouped y-fold or pair-mode tables (a
frozen copy of the plain formulas of ``sparsebev_tpu_torch/ops/msmv_pack.py``).
Plain tensor ops, so autograd takes their adjoints.

Layout: ``feat [M, H, W, C] -> [M, H, G, W+1, 2Cg]``; row h of group g holds
``feat[h, :, g] ‖ feat[h+1, :, g]`` (row H-1's second half zeros) plus a
zero guard column. Pair layout: ``[M, H, G, W+1, Cg]``, no y-interleave.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_level(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    m, h, w, c = feat.shape
    g = num_groups
    cg = c // g
    f = feat.reshape(m, h, w, g, cg)
    fy = torch.cat([f[:, 1:], torch.zeros_like(f[:, :1])], dim=1)
    t2 = torch.stack([f, fy], dim=-2)                  # [M,H,W,G,2,Cg]
    t2 = t2.permute(0, 1, 3, 2, 4, 5)                  # [M,H,G,W,2,Cg]
    t2 = F.pad(t2, (0, 0, 0, 0, 0, 1))                 # zero guard column
    return t2.reshape(m, h, g, w + 1, 2 * cg)


def pack_level_pair(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    m, h, w, c = feat.shape
    g = num_groups
    f = feat.reshape(m, h, w, g, c // g).permute(0, 1, 3, 2, 4)
    return F.pad(f, (0, 0, 0, 1))                      # zero guard column
