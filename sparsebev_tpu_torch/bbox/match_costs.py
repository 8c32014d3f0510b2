"""Matching costs (counterpart of ``sparsebev_tpu/bbox/match_costs.py``)."""

from __future__ import annotations

from typing import Sequence

import torch


def bbox3d_l1_cost(bbox_pred: torch.Tensor, gt_bboxes: torch.Tensor,
                   weight: float = 1.0) -> torch.Tensor:
    """L1 distance between ``[..., Q, D]`` predictions and ``[..., M, D]``
    ground truth -> ``[..., Q, M]``."""
    cost = torch.abs(bbox_pred[..., :, None, :]
                     - gt_bboxes[..., None, :, :]).sum(-1)
    return cost * weight


def bbox_bev_l1_cost(bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                     pc_range: Sequence[float],
                     weight: float = 1.0) -> torch.Tensor:
    """BEV-center L1 with xy normalized to [0, 1] by ``pc_range``."""
    start = torch.tensor(pc_range[0:2], dtype=bboxes.dtype,
                         device=bboxes.device)
    extent = torch.tensor(pc_range[3:5], dtype=bboxes.dtype,
                          device=bboxes.device) - start
    p = (bboxes[:, :2] - start) / extent
    g = (gt_bboxes[:, :2] - start) / extent
    return torch.abs(p[:, None, :] - g[None, :, :]).sum(-1) * weight


def iou3d_cost(iou: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Negated IoU."""
    return -iou * weight
