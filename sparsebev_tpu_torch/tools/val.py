"""Evaluation CLI of the port (counterpart of the repository's
``tools/val.py``: checkpoint load, inference over the val split, the
NDS / mAP table and a devkit-schema submission JSON — the reference's
val.py:19-137).

    python -m sparsebev_tpu_torch.tools.val --config CONFIG \\
        [--weights ckpt_N.pth | reference.pth] [--batch-size B] \\
        [--limit N] [--out submission.json] [--online] \\
        [--override key.path=value ...] [--device cuda|cpu]

Offline, every sample runs the full forward over its T frames
(``evaluation/loop.py::run_offline_eval``). ``--online`` streams the split
through ``inference.py::StreamingDetector`` with a one-batch lookahead:
sample i+1's uncached frames start their upload before sample i's forward.
CUDA unless ``--device cpu``. Launched by ``torchrun`` with more than one
rank (``WORLD_SIZE`` > 1) it joins that process group: offline, each rank
evaluates its shard of the split and rank 0 gathers the results and
computes the metrics (the JAX CLI's data-parallel evaluation over every
device); ``--online --shard-queries`` streams the split on every rank with
the head's queries sharded over them (the JAX CLI's query mesh). Rank 0
logs and writes the submission. ``main(argv)`` runs in-process and returns
a dict: ``metrics``,
``results`` (token -> decoded arrays), the host clock's ``sample_ms`` (one
per sample after the first, synchronized: each includes its wait for the
loader) and ``wait_ms``, and for ``--online`` the ring's ``frames_run`` /
``frames_reused``.
"""

from __future__ import annotations

import argparse
import logging
import os
import statistics
import time
from typing import Optional, Sequence

import torch.distributed as dist

_REPORTED = ("NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE")


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Validate SparseBEV "
                                                 "(PyTorch)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--weights", default=None,
                        help="a checkpoint of the training loop "
                             "(ckpt_<step>.pth) or a reference .pth")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--limit", type=int, default=None,
                        help="evaluate only the first N samples")
    parser.add_argument("--out", default=None, help="submission json path")
    parser.add_argument("--shard-queries", action="store_true",
                        help="with --online: shard the decoder's queries "
                             "over the torchrun ranks")
    parser.add_argument("--online", action="store_true",
                        help="streaming eval with the per-frame table ring "
                             "(reference simple_test_online; requires "
                             "batch-size 1)")
    parser.add_argument("--override", nargs="+", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain "
                             "PyTorch versions)")
    return parser.parse_args(argv)


class LoaderClock:
    """Iterates a loader and keeps, on the host clock, the time of every
    request for a batch (the last one finds the loader empty) and how long
    the loader took to answer it."""

    def __init__(self, loader):
        self.loader = loader
        self.asked, self.wait = [], []

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            self.asked.append(t0)
            try:
                batch = next(it)
            except StopIteration:
                return
            self.wait.append(time.perf_counter() - t0)
            yield batch

    def mark(self):
        self.asked.append(time.perf_counter())

    def sample_ms(self, batch_size: int, lookahead: int):
        """ms a sample of every batch after the first: the time between the
        requests that bracket its processing (with ``lookahead`` batches
        asked ahead), over the batch size."""
        times = self.asked[1 + lookahead:]
        return [(b - a) * 1e3 / batch_size for a, b in zip(times, times[1:])]


def run_online(streaming, evaluator, loader):
    """The streaming loop with a one-batch lookahead, feeding ``evaluator``.
    Returns the decoded results per sample."""
    from ..evaluation import add_batch_sample
    from ..evaluation.loop import decoded_to_host

    def names(batch):
        return batch["img_metas"][0].get("filename", [])

    results_per_sample = {}
    n_done = 0
    it = iter(loader)
    batch = next(it, None)
    if batch is not None:
        streaming.prefetch_upload(batch["img"], names(batch))
    while batch is not None:
        nxt = next(it, None)
        if nxt is not None:
            streaming.prefetch_upload(nxt["img"], names(nxt))
        dec = decoded_to_host(streaming.infer(
            batch["img"], batch["lidar2img"], batch["time_diff"],
            names(batch)))
        for i, meta in enumerate(batch["img_metas"]):
            token = meta.get("sample_idx") or f"sample_{n_done}"
            res = {k: v[i] for k, v in dec.items()}
            results_per_sample[token] = res
            add_batch_sample(evaluator, batch, i, res, token)
            n_done += 1
        logging.info("evaluated %d samples", n_done)
        batch = nxt
    return results_per_sample


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.online and args.batch_size != 1:
        raise ValueError("--online requires --batch-size 1")

    from ..bbox.nms_free_coder import build_coder
    from ..builder import build_dataloader, build_dataset
    from ..evaluation import (NuScenesDetectionEvaluator,
                              format_nusc_submission, run_offline_eval)
    from ..models.detector import build_detector
    from ..parallel import init_from_env, is_main_process, rank, world_size
    from ..utils.checkpoint_io import load_weights
    from ..utils.device import resolve_device
    from ..utils.logging import init_logging
    from .train import load_config

    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_from_env(device)
    world = world_size()
    init_logging(rank=rank())
    cfg = load_config(args.config, args.override)

    # offline with several ranks: each loads its shard of the split
    shards = 1 if args.online else world
    dataset = build_dataset(cfg.data["val"])
    if args.limit:
        dataset.data_infos = dataset.data_infos[:args.limit]
    loader = build_dataloader(dataset, batch_size=args.batch_size,
                              num_workers=cfg.data.get("workers_per_gpu", 4),
                              shard_id=rank() if shards > 1 else 0,
                              num_shards=shards, shuffle=False,
                              drop_last=False, max_gt=cfg.get("max_gt", 64))

    # the weights (and a checkpoint's VERSION tag) before any decode
    model = build_detector(cfg, device=device, seed=0)
    coder = build_coder(cfg)
    if args.weights:
        step = load_weights(model, args.weights,
                            revise_keys=cfg.get("revise_keys") or [])
        logging.info("loaded weights from %s (step %s)", args.weights, step)
    else:
        logging.warning("no --weights given: evaluating a random-init model")

    clock = LoaderClock(loader)
    out = {}
    if args.online:
        from ..inference import StreamingDetector
        streaming = StreamingDetector(
            model, num_frames=cfg.model["pts_bbox_head"]["num_frames"],
            coder=coder, device=device,
            query_group=None if not args.shard_queries or world == 1
            else dist.group.WORLD)
        evaluator = NuScenesDetectionEvaluator(classes=dataset.classes)
        results_per_sample = run_online(streaming, evaluator, clock)
        clock.mark()
        metrics = evaluator.evaluate() if evaluator._num_samples else None
        out.update(frames_run=streaming.frames_run,
                   frames_reused=streaming.frames_reused)
        logging.info("ring cache: %d frames ran the backbone, %d were found "
                     "in the ring", streaming.frames_run,
                     streaming.frames_reused)
    else:
        if shards > 1:
            logging.info("data-parallel eval over %d ranks", shards)
        metrics, results_per_sample = run_offline_eval(
            model, coder, dataset, clock, group=None)
    sample_ms = clock.sample_ms(args.batch_size, 1 if args.online else 0)
    wait_ms = [w * 1e3 / args.batch_size for w in clock.wait]
    if sample_ms:
        logging.info("%d samples: %.1f ms/sample (host clock, mean over the "
                     "samples after the first; median %.1f), loader wait "
                     "%.1f ms/sample", len(results_per_sample),
                     statistics.mean(sample_ms), statistics.median(sample_ms),
                     statistics.mean(wait_ms[1:] or wait_ms))

    if args.out and is_main_process():
        format_nusc_submission(results_per_sample, dataset.classes, args.out)
        logging.info("wrote submission to %s", args.out)

    if metrics is not None:
        logging.info("===== results =====")
        for k in _REPORTED:
            logging.info("%s: %.4f", k, metrics[k])
        for k, v in metrics.items():
            if k.startswith("AP_"):
                logging.info("%s: %.4f", k, v)
    out.update(metrics=metrics, results=results_per_sample,
               sample_ms=sample_ms, wait_ms=wait_ms)
    return out


if __name__ == "__main__":
    main()
