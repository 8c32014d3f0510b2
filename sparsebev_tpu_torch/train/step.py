"""The training step: denoising inputs, forward, losses, backward, clip and
optimizer update (counterpart of ``sparsebev_tpu/train/step.py``).

bf16 compute with fp32 parameters (no loss scaling), one process per card.
PyTorch keeps parameters, gradients and optimizer moments inside the module
and the optimizer, so :class:`TrainState` is a holder of those objects that
a step updates IN PLACE (the JAX step returns a new state), and the step
returns ``(state, metrics)`` with the JAX loss-dict keys.

Data parallelism (:class:`StepGroups`): the JAX step runs on a batch sharded
over a mesh, and the global batch supplies the loss normalizers and the
gradient. Here each rank holds its shard of the batch, and the step makes
the same numbers explicit: the normalizers (the count of valid boxes of
the detection and the denoising losses) are summed over the data group, so
each rank's loss is its share of the global-batch loss; after the backward
and before the clip every gradient is summed over the ranks in one
flattened bucket, which gives the global-batch gradient on every rank; so
every rank clips and steps AdamW identically. With a query group (hybrid
dp x sp) every q rank computes the same loss on the gathered predictions,
each rank's parameter gradients are its query shard's part
(``parallel/query_parallel.py``), and the same sum over all the ranks counts
each part once. The metrics are summed over the data group: every rank
reports the global batch's losses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..losses import (compute_detection_loss, compute_dn_loss, draw_dn_noise,
                      prepare_dn_inputs)
from ..models.layers import set_drop_path_draws, set_dropout_generator
from ..utils import tracing
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


@dataclass
class StepGroups:
    """The groups of a data-parallel step: ``data``, the ranks the batch
    shards over (the loss normalizers and the metrics sum over it);
    ``grads``, every rank of the step (the gradients sum over it); and an
    optional ``q``, the group the head's queries shard over (None: no
    sharding). A ``data`` or ``grads`` group of None is the default
    group."""
    data: Any = None
    grads: Any = None
    q: Any = None


def data_parallel_groups(group=None) -> StepGroups:
    """Plain data parallelism over ``group`` (None: every rank)."""
    return StepGroups(data=group, grads=group)


def hybrid_step_groups(groups) -> StepGroups:
    """dp x sp (``parallel.make_hybrid_groups``): the batch over
    ``groups.data``, the queries over ``groups.q``, the gradients over every
    rank."""
    return StepGroups(data=groups.data, grads=None, q=groups.q)


def sum_gradients(params, group=None) -> None:
    """Sum every parameter's gradient over ``group`` in one flattened
    bucket, in place. A parameter without a gradient on a rank adds zeros
    there, and keeps no gradient only where no rank has one (the optimizer
    then skips it, as one process would)."""
    from ..parallel import all_reduce_sum
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    p0 = params[0]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=p0.dtype, device=p0.device)
    flat = torch._utils._flatten_dense_tensors(grads + [has])
    all_reduce_sum(flat, group)
    *summed, has = torch._utils._unflatten_dense_tensors(flat, grads + [has])
    for p, g, h in zip(params, summed, has.tolist()):
        p.grad = g if h > 0 else None


def make_train_step(num_classes: int, code_weights: Sequence[float],
                    pc_range: Sequence[float], num_query: int,
                    query_denoising: bool = True, dn_groups: int = 10,
                    loss_cls_weight: float = 2.0,
                    loss_bbox_weight: float = 0.25,
                    grad_clip: float = 35.0,
                    groups: Optional[StepGroups] = None) -> Callable:
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
    reduce = query_group = None
    if groups is not None:
        from ..parallel import all_reduce_sum
        query_group = groups.q

        def reduce(t):
            return all_reduce_sum(t, groups.data)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
        with tracing.span("train.step"):
            return _step(state, batch, generator, draws or {})

    def _step(state, batch, generator, draws):
        model = state.model
        gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
        with tracing.span("train.forward"):
            dn_inputs = None
            if query_denoising:
                b, m = batch["gt_labels"].shape
                noise = draws.get("dn")
                if noise is None:
                    noise = draw_dn_noise(generator, b, dn_groups, m,
                                          num_classes,
                                          batch["gt_boxes"].device)
                dn_inputs = prepare_dn_inputs(
                    noise, *gt, num_query=num_query, num_classes=num_classes,
                    pc_range=pc_range, groups=dn_groups)

            model.aug_generator = generator
            set_dropout_generator(model, generator)
            set_drop_path_draws(model, draws.get("drop_path"))
            preds = model(batch["img"], batch["lidar2img"],
                          batch["time_diff"], dn_inputs=dn_inputs, train=True,
                          aug_draws=draws.get("aug"),
                          query_group=query_group)
        with tracing.span("train.losses"):
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

        with tracing.span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            with fp32_precision():  # the backbone's fp32 conv gradients too
                total.backward()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        if groups is not None:
            sum_gradients(params, groups.grads)
        with tracing.span("train.optimizer"):
            grad_norm = clip_by_global_norm(params, grad_clip)
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
        state.step += 1
        metrics = {"loss": total.detach(), **{k: v.detach()
                                              for k, v in losses.items()}}
        if groups is not None:      # the global batch's losses
            summed = reduce(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, summed.unbind()))
        metrics = {"loss": metrics.pop("loss"), "grad_norm": grad_norm,
                   **metrics}
        return state, metrics

    return train_step


def train_step_from_config(cfg, groups: Optional[StepGroups] = None
                           ) -> Callable:
    """:func:`make_train_step` with the head's training options of a config
    (classes, code weights, range, queries, denoising, loss weights), its
    ``optimizer_config.grad_clip`` and the data-parallel ``groups``."""
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
        grad_clip=clip.get("max_norm", 35.0), groups=groups)


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
