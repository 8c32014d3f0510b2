"""The training step: denoising inputs, forward, losses, backward, clip and
optimizer update (counterpart of ``sparsebev_tpu/train/step.py``).

bf16 compute with fp32 parameters (no loss scaling), one process per card.
PyTorch keeps parameters, gradients and optimizer moments inside the module
and the optimizer, so :class:`TrainState` is a holder of those objects that
a step updates IN PLACE (the JAX step returns a new state), and the step
returns ``(state, metrics)`` with the JAX loss-dict keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..losses import (compute_detection_loss, compute_dn_loss, draw_dn_noise,
                      prepare_dn_inputs)
from ..models.layers import set_dropout_generator
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
    (state, metrics)``.

    batch (tensors on the model's device, leading dim = batch):
    ``img [B, T*6, H, W, 3]``, ``lidar2img [B, T*6, 4, 4]``, ``time_diff
    [B, T]``, ``gt_boxes [B, M, 9]``, ``gt_labels [B, M]``, ``gt_mask
    [B, M]``. ``generator`` (on that device) seeds the denoising noise, the
    augmentations and the dropout of this step; ``draws`` may hold ``dn``
    (see ``draw_dn_noise``) and ``aug`` (see ``SparseBEV.forward``) to
    replace them. metrics: ``loss``, ``grad_norm`` (the global norm BEFORE
    the clip, frozen parameters included) and every loss of the dict, as
    0-d tensors on the device (reading one synchronizes)."""

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
            loss_bbox_weight=loss_bbox_weight)
        if dn_inputs is not None:
            losses.update(compute_dn_loss(
                preds["dn_cls_scores"], preds["dn_bbox_preds"], *gt,
                num_classes, code_weights, groups=dn_groups,
                loss_cls_weight=loss_cls_weight,
                loss_bbox_weight=loss_bbox_weight))
        total = sum(losses.values())

        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        grad_norm = clip_by_global_norm(params, grad_clip)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        metrics = {"loss": total.detach(), "grad_norm": grad_norm}
        metrics.update({k: v.detach() for k, v in losses.items()})
        return state, metrics

    return train_step


def train_step_from_config(cfg) -> Callable:
    """:func:`make_train_step` with the head's training options of a config
    (classes, code weights, range, queries, denoising, loss weights) and its
    ``optimizer_config.grad_clip``."""
    head = cfg.model["pts_bbox_head"]
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


def make_multi_step(train_step: Callable, num_steps: int) -> Callable:
    """``num_steps`` steps a call over a stacked batch (leading dim =
    ``num_steps``; the JAX ``make_multi_step``, a ``lax.scan`` there, a
    loop here). Returns ``multi_step(state, stacked_batch, generator=None)
    -> (state, stacked_metrics)`` with every metric stacked along a first
    dim of ``num_steps``. The steps draw from ``generator`` in turn, as
    ``num_steps`` single steps given it would."""

    def multi_step(state, stacked_batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        metrics = []
        for i in range(num_steps):
            state, m = train_step(
                state, {k: v[i] for k, v in stacked_batch.items()},
                generator)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return multi_step
