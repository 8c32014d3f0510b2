"""Batching + sharded sampling + threaded prefetch (host side).

The port's copy of ``sparsebev_tpu/data/loader.py``. Re-provides the loader
surface of the reference's loaders/builder.py:9-49:
deterministic per-epoch shuffling sharded across data-parallel replicas
(DistributedGroupSampler parity — all our images share one shape, so the
aspect-ratio grouping degenerates to a plain shuffle), mm*-style collate with
static GT padding (fixed shapes), and worker prefetch via threads
(JPEG decode releases the GIL in PIL).
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from .box3d import Boxes3D
from .pipelines import sample_stream


def compute_time_diff(img_timestamp: np.ndarray, num_views: int = 6) -> np.ndarray:
    """[T*N] timestamps -> [T] mean time offset of frame 0 minus frame t
    (reference models/sparsebev_transformer.py:59-64)."""
    ts = np.asarray(img_timestamp, np.float64).reshape(-1, num_views)
    diff = ts[:1] - ts
    return diff.mean(-1).astype(np.float32)


def collate_batch(samples: Sequence[Dict[str, Any]], max_gt: int = 64,
                  num_views: int = 6) -> Dict[str, Any]:
    """Stack per-sample dicts into fixed-shape arrays.

    GT is padded/truncated to ``max_gt`` with a validity mask (the
    fixed-shape replacement for mmcv's DataContainer dynamic batching)."""
    batch: Dict[str, Any] = {}
    batch["img"] = np.stack([s["img"] for s in samples])
    batch["lidar2img"] = np.stack([s["lidar2img"] for s in samples])
    batch["time_diff"] = np.stack([
        compute_time_diff(s["img_timestamp"], num_views) for s in samples])
    batch["img_metas"] = [s.get("img_metas", {}) for s in samples]
    if "ego_frame" in samples[0]:
        # [B, 3, 4] lidar->ego-relative-global affine (devkit ego distance)
        batch["ego_frame"] = np.stack(
            [np.asarray(s["ego_frame"], np.float32) for s in samples])

    if "gt_bboxes_3d" in samples[0]:
        b = len(samples)
        gt_boxes = np.zeros((b, max_gt, 9), np.float32)
        gt_labels = np.zeros((b, max_gt), np.int32)
        gt_mask = np.zeros((b, max_gt), bool)
        # per-sample presence (multi-ann_file datasets may mix infos with
        # and without num_lidar_pts); -1 = unknown, the evaluator skips
        # the devkit num_pts filter for that box
        gt_num_pts = np.full((b, max_gt), -1, np.int64)
        for i, s in enumerate(samples):
            boxes = s["gt_bboxes_3d"]
            if isinstance(boxes, Boxes3D):
                arr = boxes.gravity_boxes()
            else:
                arr = np.asarray(boxes, np.float32)
            n = min(len(arr), max_gt)
            if n > 0:
                gt_boxes[i, :n] = arr[:n, :9]
                gt_labels[i, :n] = np.asarray(s["gt_labels_3d"])[:n]
                gt_mask[i, :n] = True
                if "gt_num_pts" in s:
                    gt_num_pts[i, :n] = np.asarray(s["gt_num_pts"])[:n]
        batch["gt_boxes"] = gt_boxes
        batch["gt_labels"] = gt_labels
        batch["gt_mask"] = gt_mask
        if (gt_num_pts >= 0).any():
            batch["gt_num_pts"] = gt_num_pts
    return batch


class ShardedGroupSampler:
    """Epoch-seeded shuffled indices, sharded over replicas, padded so every
    shard sees the same count (DistributedGroupSampler semantics)."""

    def __init__(self, dataset_len: int, shard_id: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0):
        self.dataset_len = dataset_len
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Per-epoch reseed (DistSamplerSeedHook parity, train.py:152)."""
        self.epoch = epoch

    def __len__(self):
        return -(-self.dataset_len // self.num_shards)

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        per_shard = len(self)
        total = per_shard * self.num_shards
        idx = np.concatenate([idx, idx[: total - len(idx)]])
        return iter(idx[self.shard_id::self.num_shards].tolist())


class DataLoader:
    """Threaded prefetching loader yielding collated numpy batches.

    On one thread the pipeline draws from numpy's global RNG in the
    sampler's order, as the JAX loader does. On more threads each sample
    draws from its own stream, seeded by one global draw a sample in the
    sampler's order before the sample is handed to a thread
    (``pipelines.sample_stream``): the threads would otherwise take the
    global draws in whatever order they run, and two runs would differ."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[ShardedGroupSampler] = None,
                 num_workers: int = 4, max_gt: int = 64,
                 num_views: int = 6, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedGroupSampler(len(dataset), shuffle=False)
        self.num_workers = max(1, num_workers)
        self.max_gt = max_gt
        self.num_views = num_views
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = list(self.sampler)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        pending: "queue.Queue" = queue.Queue()

        def load(i, seed):
            with sample_stream(seed):
                return self.dataset[i]

        def submit(batch_idx):
            if self.num_workers == 1:
                futures = [pool.submit(self.dataset.__getitem__, i)
                           for i in batch_idx]
            else:
                futures = [pool.submit(load, i,
                                       np.random.randint(0, 2 ** 31 - 1))
                           for i in batch_idx]
            pending.put(futures)

        try:
            head = min(self.prefetch, len(batches))
            for b in batches[:head]:
                submit(b)
            for i, _ in enumerate(batches):
                futures = pending.get()
                if i + head < len(batches):
                    submit(batches[i + head])
                samples = [f.result() for f in futures]
                yield collate_batch(samples, self.max_gt, self.num_views)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
