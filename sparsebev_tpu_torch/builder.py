"""Config-driven builders of the data side (counterpart of
``sparsebev_tpu/builder.py::build_dataset`` / ``build_dataloader``, the
``build_dataset``/``build_dataloader`` surface of the reference's
train.py:98-124).

The model side has its own builders: ``models/detector.py::build_detector``,
``bbox/nms_free_coder.py::build_coder``, ``train/step.py::
train_step_from_config`` and ``train/optim.py::optimizer_from_config``.
"""

from __future__ import annotations

from typing import Any, Dict

from . import data as _data  # noqa: F401  (fills DATASETS and PIPELINES)
from .data.loader import DataLoader, ShardedGroupSampler
from .registry import DATASETS, build


def build_dataset(cfg: Dict[str, Any]):
    return build(dict(cfg), DATASETS)


def build_dataloader(dataset, batch_size: int, num_workers: int = 4,
                     shard_id: int = 0, num_shards: int = 1,
                     shuffle: bool = True, seed: int = 0,
                     max_gt: int = 64, drop_last: bool = True) -> DataLoader:
    sampler = ShardedGroupSampler(len(dataset), shard_id=shard_id,
                                  num_shards=num_shards, shuffle=shuffle,
                                  seed=seed)
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      num_workers=num_workers, max_gt=max_gt,
                      drop_last=drop_last)
