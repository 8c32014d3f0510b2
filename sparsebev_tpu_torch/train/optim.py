"""Optimizer assembly (counterpart of ``sparsebev_tpu/train/optim.py``):
AdamW + global-norm clip + the cosine / linear-warmup schedule + per-parameter
learning-rate multipliers, with ``frozen_stages`` as a 0x multiplier.

How the optax chain maps onto ``torch.optim.AdamW``. optax applies
``clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
multipliers -> learning rate``: the weight decay is added AFTER Adam and both
are scaled by ``mult * lr(step)``. ``AdamW``'s decoupled decay
``p *= 1 - lr * wd; p -= lr * adam`` is the same update exactly when the
multiplier sits in the parameter group's ``lr``, so each distinct multiplier
is one parameter group with base lr ``lr * mult`` and a ``LambdaLR`` carries
the schedule for all of them. The clip comes BEFORE the multipliers, so the
frozen parameters' gradients count in the global norm: they keep
``requires_grad`` and sit in a group with lr 0 (``AdamW`` then leaves them
untouched). :func:`clip_by_global_norm` is optax's rule (scale by
``max_norm / norm`` when the norm reaches ``max_norm``; no epsilon).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


def cosine_warmup_schedule(base_lr: float, total_steps: int,
                           warmup_iters: int = 500,
                           warmup_ratio: float = 1.0 / 3,
                           min_lr_ratio: float = 1e-3):
    """Linear warmup from ``base_lr * warmup_ratio``, then cosine to
    ``base_lr * min_lr_ratio``. Returns ``schedule(step) -> lr``."""
    min_lr = base_lr * min_lr_ratio

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_iters:
            warm_frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
            return base_lr * (warmup_ratio + (1 - warmup_ratio) * warm_frac)
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * frac))

    return schedule


def build_lr_mult_tree(named_params: Iterable[Tuple[str, torch.Tensor]],
                       custom_keys: Optional[Mapping[str, float]] = None,
                       frozen_patterns: Sequence[str] = ()) -> Dict[str, float]:
    """Per-parameter lr multiplier by parameter name: ``frozen_patterns``
    force 0, else the first matching ``custom_keys`` substring applies (mmcv
    semantics), else 1."""
    custom_keys = dict(custom_keys or {})
    mults = {}
    for name, _ in named_params:
        mult = 1.0
        if any(pat in name for pat in frozen_patterns):
            mult = 0.0
        else:
            for key, m in custom_keys.items():
                if key in name:
                    mult = float(m)
                    break
        mults[name] = mult
    return mults


def resnet_frozen_patterns(frozen_stages: int,
                           prefix: str = "img_backbone") -> list:
    """mmdet ResNet ``frozen_stages``: the stem and stages 1..k."""
    pats = []
    if frozen_stages >= 0:
        pats += [f"{prefix}.conv1.", f"{prefix}.bn1."]
    for s in range(1, frozen_stages + 1):
        pats.append(f"{prefix}.layer{s}.")
    return pats


def vovnet_frozen_patterns(frozen_stages: int,
                           prefix: str = "img_backbone") -> list:
    """VoVNet freezing: the stem and stages 2..k+1."""
    pats = []
    if frozen_stages >= 0:
        pats.append(f"{prefix}.stem.")
    for s in range(1, frozen_stages + 1):
        pats.append(f"{prefix}.stage{s + 1}.")
    return pats


def backbone_frozen_patterns(backbone_cfg: Mapping,
                             prefix: str = "img_backbone") -> list:
    """Dispatch by backbone type from the model config."""
    btype = backbone_cfg.get("type", "ResNet")
    stages = backbone_cfg.get("frozen_stages", -1)
    if btype == "ResNet":
        return resnet_frozen_patterns(stages, prefix)
    if btype == "VoVNet":
        return vovnet_frozen_patterns(stages, prefix)
    return []


@torch.no_grad()
def clip_by_global_norm(params: Sequence[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale every ``.grad`` by ``max_norm / norm`` when the global L2 norm
    of all gradients reaches ``max_norm``. Returns the norm BEFORE clipping
    (a 0-d tensor; nothing here synchronizes the device)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)).float())
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def build_optimizer(model: nn.Module, lr: float = 2e-4,
                    weight_decay: float = 0.01, total_steps: int = 100_000,
                    warmup_iters: int = 500, warmup_ratio: float = 1.0 / 3,
                    min_lr_ratio: float = 1e-3,
                    custom_keys: Optional[Mapping[str, float]] = None,
                    frozen_patterns: Sequence[str] = ()):
    """``(AdamW, LambdaLR)`` for ``model``: one parameter group per distinct
    multiplier (see the module docstring). Call ``optimizer.step()`` then
    ``scheduler.step()`` once a step; the global-norm clip is
    :func:`clip_by_global_norm`, applied by the train step."""
    schedule = cosine_warmup_schedule(lr, total_steps, warmup_iters,
                                      warmup_ratio, min_lr_ratio)
    named = list(model.named_parameters())
    mults = build_lr_mult_tree(named, custom_keys, frozen_patterns)
    groups: Dict[float, list] = {}
    for name, p in named:
        groups.setdefault(mults[name], []).append(p)
    optimizer = torch.optim.AdamW(
        [dict(params=ps, lr=lr * mult, lr_mult=mult)
         for mult, ps in sorted(groups.items())],
        lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / lr)
    return optimizer, scheduler


def optimizer_from_config(model: nn.Module, cfg, total_steps: int):
    """:func:`build_optimizer` with a config's ``optimizer`` / ``lr_config``
    sections and its backbone's frozen stages. Returns ``(optimizer,
    scheduler, grad_clip)``."""
    opt_cfg = cfg.optimizer
    custom_keys = {k: v["lr_mult"] for k, v in opt_cfg.get(
        "paramwise_cfg", {}).get("custom_keys", {}).items()}
    lr_cfg = cfg.lr_config
    optimizer, scheduler = build_optimizer(
        model, lr=opt_cfg["lr"],
        weight_decay=opt_cfg.get("weight_decay", 0.01),
        total_steps=total_steps,
        warmup_iters=lr_cfg.get("warmup_iters", 500),
        warmup_ratio=lr_cfg.get("warmup_ratio", 1 / 3),
        min_lr_ratio=lr_cfg.get("min_lr_ratio", 1e-3),
        custom_keys=custom_keys,
        frozen_patterns=backbone_frozen_patterns(cfg.model["img_backbone"]))
    clip = cfg.optimizer_config.get("grad_clip", {}).get("max_norm", 35.0)
    return optimizer, scheduler, clip
