"""DN-DETR query denoising with static shapes (counterpart of
``sparsebev_tpu/losses/denoising.py``).

Ground truth arrives padded to M slots with a validity mask; the DN pad size
is the static ``groups * M``. Each group holds an independently noised copy
of the ground truth; the attention mask isolates the groups from each other
and hides all DN slots from the match queries. Padded slots carry label
``num_classes``, zeroed features (the head zeroes them by ``dn_mask``) and
zero loss weight.

The noise is an input: :func:`draw_dn_noise` draws it from an explicit
``torch.Generator`` and :func:`prepare_dn_inputs` applies it, so a test can
inject the JAX package's draws (the two random streams cannot agree).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.box_ops import encode_bbox, normalize_bbox
from .focal import focal_loss
from .l1 import l1_loss
from .target import _sanitize_gt


def build_dn_attn_mask(num_query: int, max_gt: int, groups: int) -> np.ndarray:
    """``[DN+Q, DN+Q]`` bool, True = attention blocked. Static per config."""
    dn_pad = max_gt * groups
    total = dn_pad + num_query
    mask = np.zeros((total, total), dtype=bool)
    mask[dn_pad:, :dn_pad] = True   # match queries never see the DN queries
    for i in range(groups):         # DN group i never sees group j != i
        lo, hi = i * max_gt, (i + 1) * max_gt
        mask[lo:hi, :lo] = True
        mask[lo:hi, hi:dn_pad] = True
    return mask


def draw_dn_noise(generator: Optional[torch.Generator], batch: int,
                  groups: int, max_gt: int, num_classes: int,
                  device) -> Dict[str, torch.Tensor]:
    """The draws of :func:`prepare_dn_inputs`: ``box`` ~ U[-1, 1)
    ``[B, G, M, 3]``, ``flip`` ~ U[0, 1) ``[B, G, M]`` (a label flips where
    it is below ``label_noise_scale``) and ``label`` ~ U{0..classes-1}
    ``[B, G, M]``."""
    shape = (batch, groups, max_gt)
    return dict(
        box=torch.rand(shape + (3,), generator=generator, device=device)
        * 2.0 - 1.0,
        flip=torch.rand(shape, generator=generator, device=device),
        label=torch.randint(0, num_classes, shape, generator=generator,
                            device=device))


def prepare_dn_inputs(noise: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                      num_query: int, num_classes: int,
                      pc_range: Sequence[float], groups: int = 10,
                      bbox_noise_scale: float = 0.5,
                      label_noise_scale: float = 0.5
                      ) -> Dict[str, torch.Tensor]:
    """gt_boxes ``[B, M, 9]`` world gravity-centered; gt_labels ``[B, M]``;
    gt_mask ``[B, M]``; ``noise`` from :func:`draw_dn_noise`.

    Returns the head's ``dn_inputs``: ``dn_query_bbox [B, G*M, 10]``
    (encoded, noised), ``dn_labels [B, G*M]`` (noised; ``num_classes`` on
    padding), ``dn_mask [B, G*M]``, ``attn_mask [G*M+Q, G*M+Q]`` bool."""
    b, m = gt_labels.shape
    g = groups
    dev = gt_boxes.device
    gt_boxes = _sanitize_gt(gt_boxes, gt_mask)
    boxes = gt_boxes[:, None].expand(b, g, m, gt_boxes.shape[-1])
    labels = gt_labels.long()[:, None].expand(b, g, m)
    mask = gt_mask[:, None].expand(b, g, m)

    if bbox_noise_scale > 0:    # center noise: +- wlh / 2 * scale
        xyz = boxes[..., 0:3] + noise["box"].to(boxes.dtype) \
            * (boxes[..., 3:6] / 2) * bbox_noise_scale
        boxes = torch.cat([xyz, boxes[..., 3:]], dim=-1)
    enc = encode_bbox(boxes, pc_range)                        # [B, G, M, 10]
    enc = torch.cat([enc[..., 0:3].clamp(0.0, 1.0), enc[..., 3:]], dim=-1)

    if label_noise_scale > 0:   # label flip noise
        flip = noise["flip"] < label_noise_scale
        labels = torch.where(flip, noise["label"].long(), labels)

    enc = torch.where(mask[..., None], enc, torch.zeros_like(enc))
    labels = torch.where(mask, labels,
                         torch.full_like(labels, num_classes))
    return {
        "dn_query_bbox": enc.reshape(b, g * m, -1),
        "dn_labels": labels.reshape(b, g * m),
        "dn_mask": mask.reshape(b, g * m),
        "attn_mask": torch.from_numpy(
            build_dn_attn_mask(num_query, m, g)).to(dev),
    }


def compute_dn_loss(dn_cls_scores: torch.Tensor, dn_bbox_preds: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_mask: torch.Tensor, num_classes: int,
                    code_weights: Sequence[float], groups: int = 10,
                    dn_weight: float = 1.0, loss_cls_weight: float = 2.0,
                    loss_bbox_weight: float = 0.25) -> Dict[str, torch.Tensor]:
    """Reconstruction loss on the DN slots. Targets are the ORIGINAL
    (un-noised) boxes and labels, tiled over the groups; slot (g, i) is
    supervised iff gt i is valid."""
    num_layers, b, dn, _ = dn_cls_scores.shape
    m = gt_labels.shape[1]
    if dn != groups * m:
        raise ValueError(f"{dn} denoising slots for {groups} groups of {m}")
    dev = dn_cls_scores.device
    cw = torch.tensor(code_weights, dtype=torch.float32, device=dev)
    gt_boxes = _sanitize_gt(gt_boxes, gt_mask)
    norm_gt = normalize_bbox(gt_boxes).float()
    tgt_boxes = norm_gt.repeat(1, groups, 1)                   # [B, DN, 10]
    tgt_mask = gt_mask.repeat(1, groups)
    tgt_labels = torch.where(tgt_mask, gt_labels.long().repeat(1, groups),
                             torch.full((b, dn), num_classes,
                                        dtype=torch.int64, device=dev))
    num_tgt = torch.clamp(tgt_mask.sum().float(), min=1.0)
    w = tgt_mask[..., None].float() * cw

    out: Dict[str, torch.Tensor] = {}
    for layer in range(num_layers):
        lcls = focal_loss(dn_cls_scores[layer].reshape(-1, num_classes),
                          tgt_labels.reshape(-1),
                          tgt_mask.reshape(-1).float(), num_tgt,
                          num_classes) * loss_cls_weight
        lbox = l1_loss(dn_bbox_preds[layer].reshape(-1, tgt_boxes.shape[-1]),
                       tgt_boxes.reshape(-1, tgt_boxes.shape[-1]),
                       w.reshape(-1, w.shape[-1]), num_tgt) * loss_bbox_weight
        prefix = "" if layer == num_layers - 1 else f"d{layer}."
        out[f"{prefix}loss_cls_dn"] = dn_weight * torch.nan_to_num(lcls)
        out[f"{prefix}loss_bbox_dn"] = dn_weight * torch.nan_to_num(lbox)
    last = {k: out.pop(k) for k in ("loss_cls_dn", "loss_bbox_dn")}
    return {**last, **out}
