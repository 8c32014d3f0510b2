"""Sigmoid focal loss and the focal matching cost (counterpart of
``sparsebev_tpu/losses/focal.py``; mmdet semantics, gamma 2, alpha 0.25)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               label_weights: torch.Tensor, avg_factor, num_classes: int,
               gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """mmdet ``py_sigmoid_focal_loss`` with hard labels. logits ``[N, C]``;
    labels ``[N]`` int (``num_classes`` = background, an all-zero one-hot);
    label_weights ``[N]``; avg_factor: the scalar normalizer."""
    target = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes].to(
        logits.dtype)
    p = torch.sigmoid(logits)
    # BCE with logits, numerically stable
    ce = torch.clamp(logits, min=0) - logits * target \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    alpha_t = alpha * target + (1 - alpha) * (1 - target)
    loss = ce * alpha_t * torch.abs(target - p) ** gamma
    loss = loss.sum(-1) * label_weights
    return loss.sum() / torch.clamp(torch.as_tensor(
        avg_factor, dtype=loss.dtype, device=loss.device), min=1e-6)


def focal_loss_cost(logits: torch.Tensor, gt_labels: torch.Tensor,
                    weight: float = 2.0, gamma: float = 2.0,
                    alpha: float = 0.25, eps: float = 1e-12) -> torch.Tensor:
    """mmdet ``FocalLossCost``: logits ``[..., Q, C]``, gt_labels ``[M]`` ->
    the classification cost ``[..., Q, M]`` of each (query, gt) pair."""
    p = torch.sigmoid(logits)
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos_cost = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    idx = gt_labels.long()
    return (pos_cost[..., idx] - neg_cost[..., idx]) * weight
