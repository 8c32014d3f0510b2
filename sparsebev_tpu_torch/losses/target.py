"""Set-prediction target assignment and the per-layer losses (counterpart
of ``sparsebev_tpu/losses/target.py``): per-layer Hungarian matching (focal
classification cost + weighted L1), focal classification loss and weighted
L1 box regression, normalized by the number of valid ground-truth boxes of
the whole batch."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..bbox.match_costs import bbox3d_l1_cost
from ..ops.box_ops import normalize_bbox
from .focal import focal_loss, focal_loss_cost
from .l1 import l1_loss
from .matching import hungarian_matching


def _sanitize_gt(gt_boxes: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Replace padded gt rows with a benign box so log() stays finite."""
    safe = torch.tensor([0., 0., 0., 1., 1., 1., 0., 0., 0.],
                        dtype=gt_boxes.dtype, device=gt_boxes.device)
    return torch.where(gt_mask[..., None], gt_boxes, safe)


def matching_cost(all_cls_scores, all_bbox_preds, norm_gt, gt_labels, cw,
                  cls_cost_weight: float, reg_cost_weight: float):
    """The cost ``[L, B, M, Q]`` of every (layer, sample, gt, query)."""
    per_sample = []
    for b in range(norm_gt.shape[0]):
        c_cls = focal_loss_cost(all_cls_scores[:, b], gt_labels[b],
                                weight=cls_cost_weight)       # [L, Q, M]
        c_reg = bbox3d_l1_cost(all_bbox_preds[:, b] * cw, norm_gt[b] * cw,
                               weight=reg_cost_weight)
        per_sample.append((c_cls + c_reg).transpose(-1, -2))  # [L, M, Q]
    return torch.stack(per_sample, dim=1)


def compute_detection_loss(all_cls_scores: torch.Tensor,
                           all_bbox_preds: torch.Tensor,
                           gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                           gt_mask: torch.Tensor, num_classes: int,
                           code_weights: Sequence[float],
                           loss_cls_weight: float = 2.0,
                           loss_bbox_weight: float = 0.25,
                           cls_cost_weight: float = 2.0,
                           reg_cost_weight: float = 0.25
                           ) -> Dict[str, torch.Tensor]:
    """all_cls_scores ``[L, B, Q, C]``; all_bbox_preds ``[L, B, Q, 10]``
    (normalized layout, world coordinates); gt_boxes ``[B, M, 9]`` world
    (gravity-centered); gt_labels ``[B, M]``; gt_mask ``[B, M]`` bool.
    Returns ``loss_cls`` / ``loss_bbox`` (the last layer) and
    ``d{i}.loss_cls`` / ``d{i}.loss_bbox`` for the layers before it. All L
    layers are matched in one call of the matcher (one host round trip)."""
    num_layers, b, q, _ = all_cls_scores.shape
    dev = all_cls_scores.device
    cw = torch.tensor(code_weights, dtype=torch.float32, device=dev)
    gt_labels = gt_labels.long()
    gt_boxes = _sanitize_gt(gt_boxes, gt_mask)
    norm_gt = normalize_bbox(gt_boxes)                          # [B, M, 10]
    num_pos = torch.clamp(gt_mask.sum().float(), min=1.0)

    with torch.no_grad():
        cost = matching_cost(all_cls_scores.detach().float(),
                             all_bbox_preds.detach().float(), norm_gt,
                             gt_labels, cw, cls_cost_weight, reg_cost_weight)
        assigned = hungarian_matching(cost, gt_mask)            # [L, B, M]

    b_idx = torch.arange(b, device=dev)[:, None]
    loss_dict: Dict[str, torch.Tensor] = {}
    for layer in range(num_layers):
        # padded gt rows go to a dump slot Q that is cut off again
        q_idx = torch.where(gt_mask, assigned[layer],
                            torch.full_like(assigned[layer], q))
        labels = torch.full((b, q + 1), num_classes, dtype=torch.int64,
                            device=dev)
        labels[b_idx, q_idx] = gt_labels
        targets = torch.zeros((b, q + 1, norm_gt.shape[-1]),
                              dtype=torch.float32, device=dev)
        targets[b_idx, q_idx] = norm_gt.float()
        pos_w = torch.zeros((b, q + 1), dtype=torch.float32, device=dev)
        pos_w[b_idx, q_idx] = 1.0
        labels, targets, pos_w = labels[:, :q], targets[:, :q], pos_w[:, :q]

        cls_scores, bbox_preds = all_cls_scores[layer], all_bbox_preds[layer]
        lcls = focal_loss(cls_scores.reshape(-1, num_classes),
                          labels.reshape(-1),
                          torch.ones(b * q, dtype=torch.float32, device=dev),
                          num_pos, num_classes) * loss_cls_weight
        bbox_w = pos_w[..., None] * cw
        lbox = l1_loss(bbox_preds.reshape(-1, bbox_preds.shape[-1]),
                       targets.reshape(-1, targets.shape[-1]),
                       bbox_w.reshape(-1, bbox_w.shape[-1]),
                       num_pos) * loss_bbox_weight
        prefix = "" if layer == num_layers - 1 else f"d{layer}."
        loss_dict[f"{prefix}loss_cls"] = torch.nan_to_num(lcls)
        loss_dict[f"{prefix}loss_bbox"] = torch.nan_to_num(lbox)
    last = {k: loss_dict.pop(k) for k in ("loss_cls", "loss_bbox")}
    return {**last, **loss_dict}
