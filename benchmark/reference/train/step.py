"""The training step: denoising inputs, forward, losses, backward, clip and
optimizer update (a frozen copy of ``sparsebev_tpu_torch/train/step.py``,
commit 6b78e2d, one process).

bf16 compute with fp32 parameters (no loss scaling). :class:`TrainState`
holds the model and its optimizer, which a step updates in place; the step
returns ``(state, metrics)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..losses import (compute_detection_loss, compute_dn_loss, draw_dn_noise,
                      prepare_dn_inputs)
from ..models.layers import set_dropout_generator
from ..utils.device import fp32_precision
from .optim import clip_by_global_norm


@dataclass
class TrainState:
    """The model, its optimizer and scheduler, and the count of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0


def create_train_state(model: nn.Module, optimizer, scheduler=None) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def make_train_step(num_classes: int, code_weights: Sequence[float],
                    pc_range: Sequence[float], num_query: int,
                    query_denoising: bool = True, dn_groups: int = 10,
                    loss_cls_weight: float = 2.0,
                    loss_bbox_weight: float = 0.25,
                    grad_clip: float = 35.0) -> Callable:
    """Returns ``train_step(state, batch, generator=None, draws=None) ->
    (state, metrics)``. ``groups``: a data-parallel step (module
    docstring); ``batch`` and ``draws`` are then this rank's shard.

    batch (tensors on the model's device, leading dim = batch):
    ``img [B, T*6, H, W, 3]``, ``lidar2img [B, T*6, 4, 4]``, ``time_diff
    [B, T]``, ``gt_boxes [B, M, 9]``, ``gt_labels [B, M]``, ``gt_mask
    [B, M]``. ``generator`` (on that device) seeds the denoising noise, the
    augmentations, the dropout and the backbone's drop path of this step;
    ``draws`` may hold ``dn`` (see ``draw_dn_noise``), ``aug`` (see
    ``SparseBEV.forward``) and ``drop_path`` (a mask function, see
    ``models/layers.py::DropPath``) to replace them. metrics: ``loss``, ``grad_norm`` (the global norm BEFORE
    the clip, frozen parameters included) and every loss of the dict, as
    0-d tensors on the device (reading one synchronizes)."""
    reduce = None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
        model = state.model
        draws = draws or {}
        gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
        dn_inputs = None
        if query_denoising:
            b, m = batch["gt_labels"].shape
            noise = draws.get("dn")
            if noise is None:
                noise = draw_dn_noise(generator, b, dn_groups, m, num_classes,
                                      batch["gt_boxes"].device)
            dn_inputs = prepare_dn_inputs(
                noise, *gt, num_query=num_query, num_classes=num_classes,
                pc_range=pc_range, groups=dn_groups)

        model.aug_generator = generator
        set_dropout_generator(model, generator)
        preds = model(batch["img"], batch["lidar2img"], batch["time_diff"],
                      dn_inputs=dn_inputs, train=True,
                      aug_draws=draws.get("aug"))
        losses = compute_detection_loss(
            preds["all_cls_scores"], preds["all_bbox_preds"], *gt,
            num_classes, code_weights, loss_cls_weight=loss_cls_weight,
            loss_bbox_weight=loss_bbox_weight, reduce=reduce)
        if dn_inputs is not None:
            losses.update(compute_dn_loss(
                preds["dn_cls_scores"], preds["dn_bbox_preds"], *gt,
                num_classes, code_weights, groups=dn_groups,
                loss_cls_weight=loss_cls_weight,
                loss_bbox_weight=loss_bbox_weight, reduce=reduce))
        total = sum(losses.values())

        state.optimizer.zero_grad(set_to_none=True)
        with fp32_precision():  # the backbone's fp32 conv gradients too
            total.backward()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        grad_norm = clip_by_global_norm(params, grad_clip)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        metrics = {"loss": total.detach(), **{k: v.detach()
                                              for k, v in losses.items()}}
        metrics = {"loss": metrics.pop("loss"), "grad_norm": grad_norm,
                   **metrics}
        return state, metrics

    return train_step


def train_step_from_config(cfg) -> Callable:
    """:func:`make_train_step` with the head's training options of a config
    (classes, code weights, range, queries, denoising, loss weights), its
    ``optimizer_config.grad_clip`` and the data-parallel ``groups``."""
    head = cfg["model"]["pts_bbox_head"]
    clip = cfg.get("optimizer_config", {}).get("grad_clip", {})
    return make_train_step(
        num_classes=head["num_classes"],
        code_weights=head.get("code_weights", [1.0] * head.get("code_size", 10)),
        pc_range=head["pc_range"], num_query=head["num_query"],
        query_denoising=head.get("query_denoising", True),
        dn_groups=head.get("query_denoising_groups", 10),
        loss_cls_weight=head.get("loss_cls", {}).get("loss_weight", 2.0),
        loss_bbox_weight=head.get("loss_bbox", {}).get("loss_weight", 0.25),
        grad_clip=clip.get("max_norm", 35.0))

