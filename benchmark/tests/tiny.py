"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
configurations and traffic with small images, few queries and two frames,
through the same drivers and the port's CPU path."""

from __future__ import annotations

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import common  # noqa: E402


def tiny_config(name: str, image_hw=(64, 160), queries=16, frames=2):
    man = common.manifest(ROOT)
    cfg = common.load_json(os.path.join(
        ROOT, common.config_entry(man, name)["file"]))
    cfg = copy.deepcopy(cfg)
    head = cfg["model"]["pts_bbox_head"]
    head["num_query"] = queries
    head["num_frames"] = frames
    cfg["ida_aug_conf"]["final_dim"] = list(image_hw)
    cfg["max_gt"] = 8
    return cfg


def tiny_traffic(traffic: str) -> dict:
    params = common.load_json(common.traffic_path(traffic))
    params = dict(params, pool_frames=3, check_samples=2, profile_samples=1,
                  max_samples_per_s=4, pool_batches=2, gt_boxes=4,
                  profile_steps=1)
    return params


def run_tiny(workload_name: str, seed: int = 2**31 + 11, seconds: float = 0.5,
             control=None):
    """One run of the cell at the tiny size on the CPU; returns the result
    object run.py would print."""
    import run as bench_run
    import torch
    man = common.manifest(ROOT)
    w = common.workload(man, workload_name)
    cfg = tiny_config(w["config"])
    params = tiny_traffic(w["traffic"])
    limits = common.load_json(common.limits_path(workload_name))
    return bench_run.run_cell(w, cfg, params, limits, man, seed, seconds,
                              False, control, device=torch.device("cpu"))
