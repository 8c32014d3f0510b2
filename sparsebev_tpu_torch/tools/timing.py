"""FPS benchmark CLI of the port (counterpart of the repository's
``tools/timing.py``: warm-up, then timed streaming inference — the
reference's timing.py:77-96).

    python -m sparsebev_tpu_torch.tools.timing --config CONFIG \\
        [--samples 100] [--warmup 10] [--profile-dir DIR] \\
        [--e2e [--e2e-samples 8]] [--shard-queries] \\
        [--override key.path=value ...] [--device cuda|cpu]

The timed loop is ``inference.py::make_ring_bench``, the harness JAX's
``bench.py`` and ``tools/timing.py`` share: a seeded frame
(``RandomState(0)``, as JAX) packed into the ring slot of each sample, the
head over the last T slots, the last layer's class scores summed on the
device and read back once as the sync. The weights are seeded
(``models/detector.py::random_init_``). The output is JAX's JSON lines,
with JAX's keys: ``streaming_fps``, and with ``--e2e`` the per-sample
stream over a synthetic dataset of JPEGs at the config's image size, serial
(decode, host pipeline, upload, ring, forward, read-back one after the
other) and overlapped (the threaded loader and
``StreamingDetector.prefetch_upload``, as ``tools/val.py --online``).

``--profile-dir`` writes a ``torch.profiler`` trace of one timed loop
(``trace.json``; JAX writes a ``jax.profiler`` trace). ``--shard-queries``
under ``torchrun`` shards the head's queries over every rank (JAX: a query
mesh over every device); rank 0 prints. CUDA unless ``--device cpu``.
``main(argv)`` runs in-process and returns the printed dicts.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="SparseBEV FPS benchmark "
                                                 "(PyTorch)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--samples", type=int, default=100)
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain "
                             "PyTorch versions)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of one timed "
                             "loop to this directory")
    parser.add_argument("--e2e", action="store_true",
                        help="also time per-sample streaming over a "
                             "synthetic dataset of JPEGs: decode, host "
                             "pipeline, upload, ring, forward, serial and "
                             "with the loader and uploads overlapped")
    parser.add_argument("--e2e-samples", type=int, default=8)
    parser.add_argument("--shard-queries", action="store_true",
                        help="shard the decoder's queries over the torchrun "
                             "ranks")
    parser.add_argument("--override", nargs="+", default=None,
                        help="dotted config overrides, e.g. "
                             "model.pts_bbox_head.num_query=400")
    return parser.parse_args(argv)


def run_e2e(cfg, model, num_samples: int, device, query_group=None,
            prefetch: bool = False) -> dict:
    """Per-sample streaming over a synthetic dataset (JAX ``run_e2e``).

    ``prefetch=False``: serial, one sample at a time (JPEG decode, host
    pipeline, upload, ring update, forward, read-back). ``prefetch=True``:
    the host pipeline in the threaded loader and each sample's upload
    started before the previous sample's forward
    (``StreamingDetector.prefetch_upload``); ``host_wait_ms`` is the time
    still spent waiting for the loader, ``dispatch_upload_forward_ms`` the
    time in ``infer``."""
    import tempfile

    from ..builder import build_dataloader, build_dataset
    from ..data import make_synthetic_dataset
    from ..data.loader import collate_batch
    from ..inference import StreamingDetector

    ida = cfg.ida_aug_conf
    with tempfile.TemporaryDirectory() as root:
        ann = make_synthetic_dataset(root, num_samples=num_samples,
                                     sweeps_between=6,
                                     image_hw=(ida["H"], ida["W"]))
        val_cfg = dict(cfg.data["val"])
        val_cfg["ann_file"] = ann
        dataset = build_dataset(val_cfg)
        streaming = StreamingDetector(
            model, num_frames=cfg.model["pts_bbox_head"]["num_frames"],
            device=device, query_group=query_group)

        def names(batch):
            return batch["img_metas"][0].get("filename", [])

        def infer_batch(batch):
            preds = streaming.infer(batch["img"], batch["lidar2img"],
                                    batch["time_diff"], names(batch))
            for v in preds.values():       # the read-back is the sync
                v.cpu()

        def one(i):
            t0 = time.perf_counter()
            sample = dataset[i]
            t_host = time.perf_counter() - t0
            infer_batch(collate_batch([sample], max_gt=8))
            return t_host, time.perf_counter() - t0

        one(0)  # first use of the shapes; fills the ring
        n = len(dataset)
        if prefetch:
            loader = build_dataloader(dataset, batch_size=1, num_workers=2,
                                      shuffle=False, drop_last=False,
                                      max_gt=8)
            host_wait = dev_s = 0.0
            it = iter(loader)
            t_start = time.perf_counter()
            t0 = time.perf_counter()
            cur = next(it)
            host_wait += time.perf_counter() - t0
            streaming.prefetch_upload(cur["img"], names(cur))
            while cur is not None:
                t0 = time.perf_counter()
                nxt = next(it, None)
                host_wait += time.perf_counter() - t0
                if nxt is not None:
                    streaming.prefetch_upload(nxt["img"], names(nxt))
                t0 = time.perf_counter()
                infer_batch(cur)
                dev_s += time.perf_counter() - t0
                cur = nxt
            dt = (time.perf_counter() - t_start) / n
            return {"e2e_fps": round(1.0 / dt, 2),
                    "e2e_ms_per_sample": round(dt * 1e3, 1),
                    "host_wait_ms": round(host_wait / n * 1e3, 1),
                    "dispatch_upload_forward_ms": round(dev_s / n * 1e3, 1),
                    "overlap": "threaded-prefetch+h2d-double-buffer"}
        host_s = dev_s = 0.0
        t_start = time.perf_counter()
        for i in range(n):
            th, tt = one(i)
            host_s += th
            dev_s += tt - th
        dt = (time.perf_counter() - t_start) / n
        return {"e2e_fps": round(1.0 / dt, 2),
                "e2e_ms_per_sample": round(dt * 1e3, 1),
                "host_pipeline_ms": round(host_s / n * 1e3, 1),
                "dispatch_upload_forward_ms": round(dev_s / n * 1e3, 1)}


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    import torch.distributed as dist

    from ..inference import make_ring_bench
    from ..models.detector import build_detector
    from ..parallel import init_from_env, is_main_process, rank, world_size
    from ..utils.device import resolve_device
    from ..utils.logging import init_logging
    from .train import load_config

    args = parse_args(argv)
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_from_env(device)
    init_logging(rank=rank())
    query_group = None
    if args.shard_queries and world_size() > 1:
        query_group = dist.group.WORLD
        logging.info("query-sharding the decoder over %d ranks",
                     world_size())
    cfg = load_config(args.config, args.override)
    model = build_detector(cfg, device=device, seed=0)

    num_frames = cfg.model["pts_bbox_head"]["num_frames"]
    fh, fw = cfg.ida_aug_conf["final_dim"]
    rng = np.random.RandomState(0)
    frame = rng.uniform(0, 255, (1, 6, fh, fw, 3)).astype(np.float32)
    l2i = rng.randn(1, num_frames * 6, 4, 4).astype(np.float32)
    td = np.linspace(0, 0.5 * (num_frames - 1), num_frames,
                     dtype=np.float32)[None]
    frame, l2i, td = (torch.from_numpy(a).to(device) for a in (frame, l2i,
                                                                td))

    loop_for, ring = make_ring_bench(model, frame, l2i, td, num_frames, fh,
                                     fw, query_group=query_group)
    warm, timed = loop_for(args.warmup), loop_for(args.samples)
    ring, acc = warm(ring, frame)
    float(acc)
    t0 = time.perf_counter()
    ring, acc = timed(ring, frame)
    float(acc)
    dt = (time.perf_counter() - t0) / args.samples
    fps = 1.0 / dt
    logging.info("latency: %.2f ms, FPS: %.2f", dt * 1e3, fps)
    if args.profile_dir:
        # after the timed loop (JAX traces before it): the trace's own cost
        # stays out of the timed figure
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            ring, acc = timed(ring, frame)
            float(acc)
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logging.info("profiler trace written to %s", path)
    printed = []

    def emit(line):
        printed.append(line)
        if is_main_process():
            print(json.dumps(line), flush=True)

    emit({"metric": "streaming_fps", "value": round(fps, 2), "unit": "fps"})
    del ring

    if args.e2e:
        stats = run_e2e(cfg, model, args.e2e_samples, device,
                        query_group=query_group)
        stats["metric"] = "streaming_fps_e2e"
        logging.info("e2e per-sample (serial): %s", stats)
        emit(stats)
        stats = run_e2e(cfg, model, args.e2e_samples, device,
                        query_group=query_group, prefetch=True)
        stats["metric"] = "streaming_fps_e2e_overlapped"
        logging.info("e2e per-sample (prefetch-overlapped): %s", stats)
        emit(stats)
    return printed


if __name__ == "__main__":
    main()
