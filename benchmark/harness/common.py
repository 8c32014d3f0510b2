"""Pieces every cell shares: the manifest and the files it names, the
isolation check, the device's description and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names that may never load in a benchmark process: JAX,
# its libraries, the JAX package, and the repo-root scripts and tools that
# belong to it
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sparsebev_tpu", "bench",
                     "chip_smoke", "tools")

GIB = float(1 << 30)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_path(traffic: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{traffic}.json")


def limits_path(workload_name: str) -> str:
    return os.path.join(BENCH_DIR, "limits", f"{workload_name}.json")


def metrics_of(man: dict, workload_name: str, trace: bool) -> List[dict]:
    """The metrics a run of this cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    pool = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in pool
            if workload_name in m.get("workloads", [workload_name])]


def load_module(path: str, name: str):
    """Import a file by path (reader and counter files are named after
    metrics and kernels, whose names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The metric's reader: ``benchmark/metrics/<metric>.py`` where that
    file exists, else the shared reader its first dotted part names
    (``<kernel>_roofline``, ``idle_pct``, ``mfu``: ``harness/readers.py``)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py")
    if os.path.exists(path):
        return load_module(path,
                           "bench_metric_" + metric_name.replace(".", "_"))
    from . import readers
    return readers.shared(metric_name.split(".", 1)[0])


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation over all
    values."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def device_info(torch, dev, chips: int, peak_bytes: int) -> Dict:
    """The result line's ``device``: the platform, the card's name, the
    cards the cell uses and the peak of allocated memory."""
    return {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``)."""
    table = load_json(os.path.join(BENCH_DIR, "peaks.json"))
    for entry in table["cards"]:
        if entry["match"].lower() in kind.lower():
            return entry
    raise KeyError(f"no published peaks for {kind!r} in peaks.json")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
