"""Weighted L1 loss (counterpart of ``sparsebev_tpu/losses/l1.py``)."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
            avg_factor) -> torch.Tensor:
    """``|pred - target| * weights``, summed, over avg_factor. All ``[N, D]``."""
    loss = torch.abs(pred - target) * weights
    return loss.sum() / torch.clamp(torch.as_tensor(
        avg_factor, dtype=loss.dtype, device=loss.device), min=1e-6)
