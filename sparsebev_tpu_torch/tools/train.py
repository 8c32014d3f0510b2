"""Training CLI of the port (counterpart of the repository's
``tools/train.py``: config load + override, seeding, work dir + code backup,
dataset / loader / model / optimizer build, the runner with its hooks,
resume and pretrained loading — the reference's train.py:20-176).

    python -m sparsebev_tpu_torch.tools.train --config CONFIG \\
        [--work-dir DIR] [--epochs N] [--batch-size B] [--seed S] \\
        [--override key.path=value ...] [--device cuda|cpu]

One card per process, CUDA unless ``--device cpu``. ``--multihost`` joins
the process group that ``torchrun`` describes in the environment (NCCL on
cards, gloo with ``--device cpu``; the JAX CLI's
``jax.distributed.initialize``) and trains data-parallel: ``cfg.batch_size``
(or ``--batch-size``) is the global batch, as in JAX, and each rank loads
its shard of it. As in JAX (``make_mesh_for_batch``), the batch shards
over the first n ranks, n the largest divisor of the batch that is at most
the world (``parallel.make_group_for_batch``); the other ranks leave before
the first step and take part in no collective. ``--query-shards n`` splits
the ranks into dp x n groups (``parallel.make_hybrid_groups``; n must
divide the world): the batch over dp, each shard's decoder queries over n.
Rank 0 logs, writes checkpoints and keeps the evaluation; every rank of the
run resumes from the same checkpoint.

    torchrun --nproc_per_node 8 -m sparsebev_tpu_torch.tools.train \
        --config CONFIG --multihost [--query-shards 2]

``main(argv)`` runs in-process and returns the finished ``Runner`` (None on
a rank that the batch leaves out).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Train SparseBEV (PyTorch)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--override", nargs="+", default=None,
                        help="config overrides: key.path=value")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain "
                             "PyTorch versions)")
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel training: join the process "
                             "group of the torchrun environment")
    parser.add_argument("--query-shards", type=int, default=1,
                        help="hybrid dp x sp training: shard the decoder's "
                             "queries over this many ranks per batch shard")
    return parser.parse_args(argv)


def load_config(path: str, overrides=None, **top_level):
    """``Config.fromfile`` with ``--override`` pairs applied, then the
    top-level keys given (those that are not None)."""
    from ..config import Config
    cfg = Config.fromfile(path)
    if overrides:
        cfg.merge_from_dict(dict(kv.split("=", 1) for kv in overrides))
    for key, value in top_level.items():
        if value is not None:
            cfg[key] = value
    return cfg


def build_eval_fn(cfg, group=None):
    """``eval_fn(state) -> metrics`` over ``cfg.data.val`` for the
    ``EvalHook``, or None when the config names no val infos file that
    exists. With more than one rank in ``group`` each rank evaluates its
    shard of the split and rank 0 gets the metrics (None elsewhere)."""
    from ..parallel import rank, world_size
    from ..bbox.nms_free_coder import build_coder
    from ..builder import build_dataloader, build_dataset
    from ..evaluation import run_offline_eval

    val_cfg = cfg.data.get("val") or {}
    ann = val_cfg.get("ann_file")
    ann_first = ann[0] if isinstance(ann, (list, tuple)) else ann
    if not ann_first or not os.path.exists(ann_first):
        return None
    val_dataset = build_dataset(cfg.data["val"])
    val_loader = build_dataloader(
        val_dataset, batch_size=1,
        num_workers=cfg.data.get("workers_per_gpu", 4),
        shard_id=rank(group), num_shards=world_size(group),
        shuffle=False, drop_last=False, max_gt=cfg.get("max_gt", 64))
    coder = build_coder(cfg)

    def eval_fn(state):
        metrics, _ = run_offline_eval(state.model, coder, val_dataset,
                                      val_loader, group=group)
        return metrics

    return eval_fn


def main(argv: Optional[Sequence[str]] = None, extra_hooks=()):
    """Train as the command line says. ``extra_hooks`` are appended to the
    config's hooks (for in-process callers that watch the run). Returns the
    ``Runner`` after its last epoch, or None on a rank outside the data
    group."""
    args = parse_args(argv)

    from ..builder import build_dataloader, build_dataset
    from ..models.detector import build_detector
    from ..parallel import (init_from_env, is_main_process,
                            make_group_for_batch, make_hybrid_groups, rank,
                            world_size)
    from ..train import hooks as H
    from ..train.optim import cosine_warmup_schedule, optimizer_from_config
    from ..train.runner import Runner
    from ..train.step import (create_train_state, data_parallel_groups,
                              hybrid_step_groups, train_step_from_config)
    from ..utils.checkpoint_io import (latest_checkpoint, load_pretrained,
                                       load_torch_checkpoint)
    from ..utils.device import resolve_device
    from ..utils.logging import backup_code, init_logging

    device = resolve_device(args.device)
    if args.multihost:
        device = init_from_env(device)
    cfg = load_config(args.config, args.override, total_epochs=args.epochs,
                      batch_size=args.batch_size)

    # the ranks: dp x sp groups over every rank with --query-shards (JAX's
    # hybrid mesh), else data parallelism over the largest world that
    # divides the batch; the evaluation shards over the ranks that train
    world = world_size()
    step_groups, data_group, eval_group, data_index, dp = (None, None, None,
                                                          0, 1)
    if args.query_shards > 1:
        if world % args.query_shards:
            raise ValueError(f"--query-shards {args.query_shards} does not "
                             f"divide the {world} rank(s) (launch with "
                             "torchrun and --multihost)")
        hybrid = make_hybrid_groups(world // args.query_shards,
                                    args.query_shards)
        step_groups = hybrid_step_groups(hybrid)
        data_group, data_index, dp = hybrid.data, hybrid.data_index, hybrid.dp
        if cfg.batch_size % dp:
            raise ValueError(f"a global batch of {cfg.batch_size} does not "
                             f"shard over {dp} data-parallel ranks")
    elif world > 1:
        data_group, dp = make_group_for_batch(cfg.batch_size)
        if rank() >= dp:
            logging.warning("rank %d leaves: a global batch of %d trains on "
                            "%d of the %d ranks", rank(), cfg.batch_size, dp,
                            world)
            return None
        step_groups = data_parallel_groups(data_group)
        eval_group, data_index = data_group, rank()

    work_dir = args.work_dir or os.path.join(
        "outputs", os.path.splitext(os.path.basename(args.config))[0],
        time.strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(work_dir, exist_ok=True)
    init_logging(os.path.join(work_dir, "train.log"),
                 debug=cfg.get("debug", False), rank=rank())
    if is_main_process():
        backup_code(work_dir)
    logging.info("work dir: %s", work_dir)
    logging.info("device: %s, %d rank(s), %d data-parallel", device, world,
                 dp)
    np.random.seed(args.seed)

    # data: this rank's shard of every global batch
    dataset = build_dataset(cfg.data["train"])
    loader = build_dataloader(
        dataset, batch_size=cfg.batch_size // dp,
        num_workers=cfg.data.get("workers_per_gpu", 4),
        shard_id=data_index, num_shards=dp, shuffle=True,
        seed=args.seed, max_gt=cfg.get("max_gt", 64))
    logging.info("dataset: %d samples, %d iters/epoch", len(dataset),
                 len(loader))

    # model
    model = build_detector(cfg, device=device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("model params: %.2fM", n_params / 1e6)

    # pretrained warm start (reference train.py:164-174)
    if cfg.get("load_from"):
        load_pretrained(model, load_torch_checkpoint(cfg.load_from),
                        revise_keys=cfg.get("revise_keys") or [])
        logging.info("loaded pretrained weights from %s", cfg.load_from)

    # optimizer and step
    total_steps = cfg.total_epochs * len(loader)
    optimizer, scheduler, _ = optimizer_from_config(model, cfg, total_steps)
    state = create_train_state(model, optimizer, scheduler)
    lr_cfg = cfg.lr_config
    schedule = cosine_warmup_schedule(
        cfg.optimizer["lr"], total_steps, lr_cfg.get("warmup_iters", 500),
        lr_cfg.get("warmup_ratio", 1 / 3), lr_cfg.get("min_lr_ratio", 1e-3))
    train_step = train_step_from_config(cfg, step_groups)

    hooks = [H.IterTimerHook(), H.SamplerSeedHook()]
    for hcfg in cfg.get("log_config", {}).get("hooks", []):
        if hcfg["type"] == "TextLoggerHook":
            hooks.append(H.TextLoggerHook(interval=hcfg.get("interval", 1)))
        elif hcfg["type"] == "TensorboardLoggerHook":
            hooks.append(H.TensorboardLoggerHook(
                interval=hcfg.get("interval", 50)))
    ck = cfg.get("checkpoint_config", {})
    hooks.append(H.CheckpointHook(interval=ck.get("interval", 1),
                                  max_keep_ckpts=ck.get("max_keep_ckpts", 1)))

    # training-time eval (the reference registers Dist/EvalHook at
    # interval=total_epochs, train.py:154-158 / eval_config)
    eval_interval = cfg.get("eval_config", {}).get("interval",
                                                   cfg.total_epochs)
    if eval_interval > 0:
        eval_fn = build_eval_fn(cfg, eval_group)
        if eval_fn is not None:
            hooks.append(H.EvalHook(interval=eval_interval, eval_fn=eval_fn))
    hooks.extend(extra_hooks)

    # the step's draws differ between batch shards and agree within a q
    # group (its ranks hold the same shard)
    runner = Runner(train_step, state, loader, work_dir,
                    total_epochs=cfg.total_epochs, lr_schedule=schedule,
                    hooks=hooks, device=device, seed=args.seed + data_index,
                    steps_per_dispatch=cfg.get("steps_per_dispatch", 1),
                    group=data_group)

    resume_from = cfg.get("resume_from")
    if resume_from == "auto":
        resume_from = latest_checkpoint(work_dir)
    if resume_from:
        runner.resume(resume_from)

    runner.run()
    logging.info("training done at step %d", runner.global_step)
    return runner


if __name__ == "__main__":
    main()
