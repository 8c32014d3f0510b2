"""Checkpoints of the training loop, and pretrained weights from reference
``.pth`` files (counterpart of ``sparsebev_tpu/utils/checkpoint_io.py``).

A training checkpoint is one ``torch.save`` file ``work_dir/ckpt_{step}.pth``
holding the model's and the optimizer's ``state_dict``, the scheduler's,
the step and an ``extra`` dict (the epoch, and the VERSION tag that the
forward depends on). :func:`save_checkpoint` keeps the newest ``max_keep``;
:func:`restore_train_state` is the full resume. The JAX package's orbax
checkpoints are not read here: a JAX parameter tree reaches the port through
``utils/convert.py::state_dict_from_jax``.

Pretrained weights: the port's modules carry the reference's state-dict key
names, so a reference checkpoint loads after the ``revise_keys`` remap alone
(:func:`load_pretrained`, what the JAX package's ``port_torch_params`` and
``merge_pretrained`` do with their key map).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

_CKPT = re.compile(r"ckpt_(\d+)\.pth$")


def _checkpoints(work_dir: str):
    """``(step, file name)`` of the checkpoints in ``work_dir``, oldest
    first."""
    if not os.path.isdir(work_dir):
        return []
    found = ((int(m.group(1)), f) for f in os.listdir(work_dir)
             if (m := _CKPT.match(f)))
    return sorted(found)


def save_checkpoint(work_dir: str, step: int, state, max_keep: int = 1,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save the train state under ``work_dir/ckpt_{step}.pth`` and prune to
    the newest ``max_keep`` checkpoints. Returns the path."""
    from .version import VERSION
    extra = dict(extra or {})
    extra.setdefault("version", VERSION.name)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": (None if state.scheduler is None
                      else state.scheduler.state_dict()),
        "step": int(state.step),
        "extra": extra,
    }
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(work_dir, f"ckpt_{step}.pth"))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)           # a crash mid-save leaves no half file
    for _, name in _checkpoints(work_dir)[:-max_keep]:
        os.remove(os.path.join(work_dir, name))
    return path


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The newest checkpoint in ``work_dir`` by step, or None."""
    found = _checkpoints(work_dir)
    return os.path.join(work_dir, found[-1][1]) if found else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a :func:`save_checkpoint` file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, state):
    """Full resume: weights, optimizer and scheduler state, step, and the
    VERSION tag (the forward is VERSION-dependent: a resume from a ported
    v0.17.1 checkpoint must restore it, as ``load_torch_checkpoint`` does).
    Loads into ``state`` in place and returns it."""
    return apply_checkpoint(load_checkpoint(path), state)


def apply_checkpoint(payload: Dict[str, Any], state):
    """:func:`restore_train_state` from a payload already loaded."""
    tag = payload.get("extra", {}).get("version")
    if tag is not None:
        from .version import VERSION
        VERSION.name = str(tag)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.scheduler is not None and payload.get("scheduler") is not None:
        state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    return state


# ---------------------------------------------------------------------------
# pretrained reference checkpoints
# ---------------------------------------------------------------------------

def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` state dict (the ``state_dict`` or ``model``
    entry when it has one). Side effect: a top-level ``version`` tag
    (released SparseBEV checkpoints carry one) sets the VERSION singleton, so
    the v0.17.1 yaw convention and decode swap apply."""
    return reference_state_dict(
        torch.load(path, map_location="cpu", weights_only=False))


def reference_state_dict(ckpt) -> Dict[str, torch.Tensor]:
    """:func:`load_torch_checkpoint` on a checkpoint already loaded."""
    if isinstance(ckpt, dict) and "version" in ckpt:
        from .version import VERSION
        VERSION.name = str(ckpt["version"])
        logging.info("checkpoint version tag: %s", VERSION.name)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in ckpt.items()}


def apply_revise_keys(state_dict: Dict[str, Any],
                      revise_keys: Sequence[Tuple[str, str]]
                      ) -> Dict[str, Any]:
    """mmcv ``revise_keys``: regex remaps applied in order, e.g.
    ``('backbone', 'img_backbone')``."""
    out = dict(state_dict)
    for pattern, repl in revise_keys:
        out = {re.sub(pattern, repl, k): v for k, v in out.items()}
    return out


def load_pretrained(model: nn.Module, state_dict: Dict[str, torch.Tensor],
                    revise_keys: Sequence[Tuple[str, str]] = (),
                    logger=logging) -> Dict[str, list]:
    """Copy every key of ``state_dict`` (after ``revise_keys``) that the
    model has into it, in the model's dtype; a shape mismatch raises. Keys
    the model lacks are logged as ``merge_pretrained`` logs them and
    skipped (the reference's non-strict load); the model's keys the
    checkpoint lacks keep their values. A checkpoint with reference
    ``backbone.`` keys and no ``img_backbone.`` keys loads into the
    backbone, as ``port_torch_params`` picks its prefix (``neck.`` likewise
    into ``img_neck.``); BN ``num_batches_tracked`` counters are skipped
    silently, as the JAX porting never reads them. Returns the
    ``missing`` (model keys not loaded) and ``unexpected`` (checkpoint keys
    not used) lists."""
    sd = apply_revise_keys(state_dict, revise_keys)
    if not any(k.startswith("img_backbone.") for k in sd):
        sd = {("img_" + k if k.startswith("backbone.") else k): v
              for k, v in sd.items()}
    sd = {("img_" + k if k.startswith("neck.") else k): v
          for k, v in sd.items()}
    own = model.state_dict()
    unexpected, loaded = [], 0
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith(".num_batches_tracked") and k not in own:
                continue        # BN counters: the frozen BNs keep none
            if k not in own:
                logger.warning("pretrained leaf %s missing in model", k)
                unexpected.append(k)
                continue
            if tuple(own[k].shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: "
                                 f"{tuple(own[k].shape)} vs {tuple(v.shape)}")
            own[k].copy_(v.to(own[k].dtype))
            loaded += 1
    missing = [k for k in own if k not in sd]
    logger.info("loaded %d pretrained tensors; %d model tensors not in the "
                "checkpoint", loaded, len(missing))
    return {"missing": missing, "unexpected": unexpected}


def load_weights(model: nn.Module, path: str,
                 revise_keys: Sequence[Tuple[str, str]] = ()) -> Optional[int]:
    """Weights for evaluation: a checkpoint of the training loop (its model
    state, strictly; its ``extra.version`` restored into VERSION, as the
    JAX val CLI restores it before any decode) or a reference ``.pth``
    (through :func:`load_pretrained`, its top-level ``version`` tag
    applied). Returns the checkpoint's step, or None for a ``.pth``."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(payload, dict)
            and {"model", "step", "extra"} <= set(payload)):
        load_pretrained(model, reference_state_dict(payload), revise_keys)
        return None
    tag = payload["extra"].get("version")
    if tag is not None:
        from .version import VERSION
        VERSION.name = str(tag)
        logging.info("checkpoint version: %s", VERSION.name)
    model.load_state_dict(payload["model"], strict=True)
    return int(payload["step"])
