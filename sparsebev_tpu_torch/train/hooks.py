"""Training hooks (counterpart of ``sparsebev_tpu/train/hooks.py``): the
iteration timer, the text and TensorBoard loggers, per-epoch checkpoints, the
sampler's epoch seed and an evaluation callback.

Hook protocol: objects with any of ``before_run / before_epoch / after_iter /
after_epoch`` taking the runner (``after_iter`` also the step's metrics as
floats).

In a data-parallel run the loggers write and the evaluation's results are
kept on rank 0 only (``parallel.is_main_process``); every rank runs the
evaluation (its shard of the split) and reaches the checkpoint hook, where
only rank 0 writes.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

from ..parallel import is_main_process
from ..registry import HOOKS


class Hook:
    def before_run(self, runner):
        pass

    def before_epoch(self, runner):
        pass

    def after_iter(self, runner, metrics: Dict[str, Any]):
        pass

    def after_epoch(self, runner):
        pass


@HOOKS.register_module()
class IterTimerHook(Hook):
    """Tracks data_time (host wait) and iter time in ``runner.log_vars``."""

    def before_epoch(self, runner):
        self._t = time.perf_counter()

    def before_iter(self, runner):
        now = time.perf_counter()
        runner.log_vars["data_time"] = now - self._t
        self._t = now

    def after_iter(self, runner, metrics):
        now = time.perf_counter()
        runner.log_vars["time"] = now - self._t
        self._t = now


@HOOKS.register_module()
class TextLoggerHook(Hook):
    """Log line per interval: epoch/iter, lr, eta, times, losses (the JAX
    hook's line)."""

    def __init__(self, interval: int = 1):
        self.interval = interval

    def after_iter(self, runner, metrics):
        if (runner.iter + 1) % self.interval != 0 or not is_main_process():
            return
        iters_per_epoch = runner.iters_per_epoch
        total_iters = runner.total_epochs * iters_per_epoch
        done = runner.global_step
        eta = (total_iters - done) * runner.log_vars.get("time", 0.0)
        eta_str = time.strftime("%H:%M:%S", time.gmtime(max(eta, 0)))
        loss_items = ", ".join(
            f"{k}: {float(v):.4f}" for k, v in sorted(metrics.items())
            if not k.startswith("d"))
        logging.info(
            "Epoch [%d/%d][%d/%d] lr: %.3e, eta: %s, time: %.3f, "
            "data_time: %.3f, %s",
            runner.epoch + 1, runner.total_epochs, runner.iter + 1,
            iters_per_epoch, runner.current_lr(), eta_str,
            runner.log_vars.get("time", 0.0),
            runner.log_vars.get("data_time", 0.0), loss_items)


@HOOKS.register_module()
class TensorboardLoggerHook(Hook):
    """Totals under ``train/``, the intermediate-layer (d0..d4) losses
    dropped. A no-op, said once in the log, when ``torch.utils.tensorboard``
    cannot be imported."""

    def __init__(self, log_dir: Optional[str] = None, interval: int = 50):
        self.interval = interval
        self.log_dir = log_dir
        self.writer = None

    def before_run(self, runner):
        if not is_main_process():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logging.info("tensorboard unavailable; TB logging disabled")
            return
        self.writer = SummaryWriter(self.log_dir or runner.work_dir)

    def after_iter(self, runner, metrics):
        if self.writer is None or runner.global_step % self.interval != 0:
            return
        for k, v in metrics.items():
            if k.startswith("d"):  # drop d0..d4 intermediate losses
                continue
            self.writer.add_scalar(f"train/{k}", float(v), runner.global_step)
        self.writer.add_scalar("train/lr", runner.current_lr(),
                               runner.global_step)

    def after_epoch(self, runner):
        if self.writer is not None:
            self.writer.flush()


@HOOKS.register_module()
class CheckpointHook(Hook):
    """Per-epoch save keeping the newest ``max_keep_ckpts``
    (``checkpoint_config`` of the configs)."""

    def __init__(self, interval: int = 1, max_keep_ckpts: int = 1):
        self.interval = interval
        self.max_keep = max_keep_ckpts

    def after_epoch(self, runner):
        if (runner.epoch + 1) % self.interval != 0:
            return
        from ..utils.checkpoint_io import save_checkpoint
        path = save_checkpoint(runner.work_dir, runner.global_step,
                               runner.state, max_keep=self.max_keep,
                               extra={"epoch": runner.epoch + 1})
        if path is not None:
            logging.info("saved checkpoint to %s", path)


@HOOKS.register_module()
class SamplerSeedHook(Hook):
    """Reseeds the loader's sampler every epoch, where it has one with a
    ``set_epoch``."""

    def before_epoch(self, runner):
        sampler = getattr(runner.loader, "sampler", None)
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(runner.epoch)


@HOOKS.register_module()
class EvalHook(Hook):
    """Runs a caller-given ``eval_fn(state)`` at an epoch interval
    (``eval_config`` of the configs) on every rank; rank 0 logs and keeps
    the results."""

    def __init__(self, interval: int, eval_fn=None):
        self.interval = interval
        self.eval_fn = eval_fn

    def after_epoch(self, runner):
        if self.eval_fn is None or (runner.epoch + 1) % self.interval != 0:
            return
        results = self.eval_fn(runner.state)
        if not is_main_process():
            return
        logging.info("eval @ epoch %d: %s", runner.epoch + 1, results)
        runner.eval_results = results
