"""Shared offline evaluation loop (counterpart of
``sparsebev_tpu/evaluation/loop.py``): the full forward and the NMS-free
decode over a val loader, on one card.

The JAX loop jits ``model.apply`` + ``coder.decode``; here the forward is
``SparseBEV.forward(train=False)`` under ``torch.inference_mode()`` on the
model's device, then the coder's decode, and the decoded arrays come back
to the host. The metas, ``gt_*``, ``ego_frame`` and ``gt_num_pts`` stay on
the host for the evaluator. Tail batches are padded to the first batch's
size (and masked out of the evaluator), as in JAX. The JAX loop's ``mesh``
(data parallelism over devices) is not ported: a mesh raises.

Used by ``tools/val.py`` and the training-time ``EvalHook`` (the reference
registers DistEvalHook at interval=total_epochs, train.py:154-158).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_MODEL_INPUTS = ("img", "lidar2img", "time_diff")


def add_batch_sample(evaluator, batch, i, res, token):
    """Feed one decoded sample into the evaluator with the devkit filters
    (gt_mask slicing, ego-pose frame, num_lidar_pts) — the single shared
    implementation for the online (tools/val.py) and offline loops, so the
    two paths can never apply different filters."""
    if "gt_boxes" not in batch:
        return
    m = batch["gt_mask"][i]
    evaluator.add_sample(
        res["bboxes"], res["scores"], res["labels"],
        batch["gt_boxes"][i][m], batch["gt_labels"][i][m],
        pred_mask=res["mask"], sample_token=token,
        ego_frame=(batch["ego_frame"][i]
                   if "ego_frame" in batch else None),
        gt_num_pts=(batch["gt_num_pts"][i][m]
                    if "gt_num_pts" in batch else None))


def decoded_to_host(dec: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The coder's output as numpy arrays (reading them waits for the
    device)."""
    return {k: v.cpu().numpy() for k, v in dec.items()}


def run_offline_eval(model, coder, dataset, loader, mesh=None):
    """``model``: a ``SparseBEV`` holding its weights, on the device the
    forward runs on. Returns ``(metrics dict or None, results_per_sample
    dict)``."""
    from .metrics import NuScenesDetectionEvaluator

    if mesh is not None:
        raise NotImplementedError(
            "data-parallel evaluation over a device mesh is not ported yet "
            "(ROADMAP Queue 1 item 12); run without a mesh on one card")
    device = next(model.parameters()).device
    evaluator = NuScenesDetectionEvaluator(classes=dataset.classes)
    results_per_sample = {}
    n_done = 0
    static_bs = None
    for batch in loader:
        metas = batch["img_metas"]
        n_real = len(metas)
        if static_bs is None:
            static_bs = n_real
        arrs = {k: np.asarray(batch[k]) for k in _MODEL_INPUTS}
        if n_real < static_bs:  # pad the tail batch to the static size
            pad = static_bs - n_real
            arrs = {k: np.concatenate([v] + [v[-1:]] * pad) for k, v in
                    arrs.items()}
        with torch.inference_mode():
            inputs = [torch.from_numpy(np.ascontiguousarray(arrs[k])).to(
                device) for k in _MODEL_INPUTS]
            preds = model(*inputs, train=False)
            dec = decoded_to_host(coder.decode(preds))
        for i, meta in enumerate(metas):
            token = meta.get("sample_idx") or f"sample_{n_done}"
            res = {k: v[i] for k, v in dec.items()}
            results_per_sample[token] = res
            add_batch_sample(evaluator, batch, i, res, token)
            n_done += 1

    metrics = evaluator.evaluate() if evaluator._num_samples > 0 else None
    return metrics, results_per_sample
