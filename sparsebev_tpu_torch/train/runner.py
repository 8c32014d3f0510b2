"""Epoch-based training runner (counterpart of
``sparsebev_tpu/train/runner.py``): a host loop over a loader that calls the
train step, fires the hooks, and saves and resumes checkpoints.

One card per process; ``device`` and ``group`` take the place of the JAX
runner's mesh. In a data-parallel run every rank runs a ``Runner`` over its
shard of the loader (``build_dataloader(shard_id=..., num_shards=...)``)
with a step made for the group (``train/step.py::StepGroups``); ``group``
is the data-parallel group, whose ranks wait for each other at the end of
every epoch (after rank 0's checkpoint), and the hooks log, save and keep
the evaluation on rank 0 only. The loader is anything with
``__len__`` and ``__iter__`` that yields collated batches of numpy arrays
(``img_metas``, when present, is dropped); each batch goes to the device
through pinned host memory. The step's draws (denoising noise,
augmentations, dropout) come from one ``torch.Generator`` on the device,
seeded with ``seed`` when :meth:`Runner.run` starts; as in the JAX runner,
:meth:`Runner.resume` restores the train state, the step and the epoch, not
that generator.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel import barrier
from ..utils import tracing
from ..utils.device import resolve_device
from .hooks import Hook, IterTimerHook
from .step import make_multi_step


class Runner:
    def __init__(self,
                 train_step_fn: Callable,
                 state,
                 loader,
                 work_dir: str,
                 total_epochs: int,
                 lr_schedule: Optional[Callable] = None,
                 hooks: Optional[List[Hook]] = None,
                 device=None,
                 seed: int = 0,
                 steps_per_dispatch: int = 1,
                 group=None):
        """``train_step_fn(state, batch, generator) -> (state, metrics)``
        (``train/step.py``), with ``state`` on ``device`` (CUDA unless the
        caller passes ``"cpu"``). ``steps_per_dispatch > 1`` runs K steps a
        call through ``make_multi_step`` on K stacked batches; hooks then
        fire once a call with the K metrics averaged."""
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self.train_step_fn = train_step_fn
        if self.steps_per_dispatch > 1:
            self.train_step_fn = make_multi_step(train_step_fn,
                                                 self.steps_per_dispatch)
        self.state = state
        self.loader = loader
        self.work_dir = work_dir
        self.total_epochs = total_epochs
        self.lr_schedule = lr_schedule
        self.hooks = hooks or []
        self.device = resolve_device(device)
        self.seed = seed
        self.group = group

        self.epoch = 0
        self.iter = 0
        self.log_vars: Dict[str, Any] = {}
        self.eval_results: Dict[str, Any] = {}
        os.makedirs(work_dir, exist_ok=True)

    @property
    def iters_per_epoch(self) -> int:
        return len(self.loader) // self.steps_per_dispatch

    @property
    def global_step(self) -> int:
        return int(self.state.step)

    def current_lr(self) -> float:
        if self.lr_schedule is None:
            return 0.0
        return float(self.lr_schedule(self.global_step))

    def _call_hooks(self, event: str, *args):
        for h in self.hooks:
            fn = getattr(h, event, None)
            if fn is not None:
                fn(self, *args)

    def resume(self, path: str):
        """Full-state resume: weights, optimizer, scheduler, step, epoch."""
        from ..utils.checkpoint_io import apply_checkpoint, load_checkpoint
        payload = load_checkpoint(path)
        self.state = apply_checkpoint(payload, self.state)
        self.epoch = int(payload.get("extra", {}).get("epoch", 0))
        logging.info("resumed from %s at step %d (epoch %d)",
                     path, self.global_step, self.epoch)

    def upload(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch of numpy arrays as tensors on the device (through
        pinned memory, asynchronously, when the device is a card)."""
        out = {}
        with tracing.span("train.upload"):
            for k, v in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    def run(self):
        generator = torch.Generator(self.device).manual_seed(self.seed)
        self._call_hooks("before_run")
        start_epoch = self.epoch
        for epoch in range(start_epoch, self.total_epochs):
            self.epoch = epoch
            self._call_hooks("before_epoch")
            timer = next((h for h in self.hooks
                          if isinstance(h, IterTimerHook)), None)
            for i, batch in enumerate(self._iter_batches()):
                self.iter = i
                batch = self.upload(batch)
                if timer is not None:
                    timer.before_iter(self)
                self.state, metrics = self.train_step_fn(
                    self.state, batch, generator)
                # with K steps per call, the metrics are [K]: average
                metrics = {k: float(v.float().mean())
                           for k, v in metrics.items()}
                self._call_hooks("after_iter", metrics)
            self._call_hooks("after_epoch")
            # rank 0 wrote the epoch's checkpoint: no rank runs on (or
            # returns, to a caller that reads it) before it is there
            barrier(self.group)
        return self.state

    def _iter_batches(self):
        """Yield per-call batches: plain batches for steps_per_dispatch=1,
        K-stacked batches otherwise (dropping a trailing partial group)."""
        k = self.steps_per_dispatch
        if k == 1:
            for batch in self.loader:
                batch.pop("img_metas", None)
                yield batch
            return
        group = []
        for batch in self.loader:
            batch.pop("img_metas", None)
            group.append(batch)
            if len(group) == k:
                yield {key: np.stack([b[key] for b in group])
                       for key in group[0]}
                group = []
        if group:  # no silent caps: a trailing partial group cannot fill a
            # K-step call, so it is skipped — say so
            logging.info(
                "steps_per_dispatch=%d drops a trailing partial group of "
                "%d batch(es) this epoch", k, len(group))
