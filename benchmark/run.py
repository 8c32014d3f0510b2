"""Run one benchmark cell once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell's entry in ``BENCHMARK.json`` names its configuration (a file
under ``benchmark/configs/``) and its traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``driver`` key picks the
driver (``benchmark/harness/<driver>.py``); its comparison limits are in
``benchmark/limits/<workload>.json`` and each per-layer metric has a reader
in ``benchmark/metrics/<metric>.py`` or shares one by the first part of
its name (``harness/readers.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last the numbers compared
beside their limits, which also end standard error.

``--control <name>`` runs the cell's lower-precision control instead (a
check of the comparison, not a measurement; PERF.md).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library may pull in
    JAX through its Flax integration."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)


class Context:
    """What a driver gets: the cell's inputs and the run's clocks."""

    def __init__(self, torch, device, cfg, params, seed, seconds, trace,
                 control, chips, peaks):
        self.torch = torch
        self.device = device
        self.cfg = cfg
        self.params = params
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.control = control
        self.chips = chips
        self.peaks = peaks
        self.setup_s = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - T_START

    def read_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))


def run_cell(workload: dict, cfg: dict, params: dict, limits: dict,
             man: dict, seed: int, seconds: float, trace: bool,
             control=None, device=None) -> dict:
    """One run of one cell; returns the result object (not yet printed)."""
    import importlib

    import torch

    from harness import common
    from harness.check import judge, not_compared

    chips = workload["chips"]
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            raise SystemExit(
                f"run.py: the cell needs {chips} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peaks = common.peaks(kind) if device.type == "cuda" else {}
    ctx = Context(torch, device, cfg, params, seed, seconds, trace, control,
                  chips, peaks)
    driver = importlib.import_module(f"harness.{params['driver']}")
    res = driver.run(ctx)

    correct, rows = judge(res["numbers"], limits)
    extra = not_compared(res["numbers"], limits)
    if extra:
        common.log("not compared: " + " ".join(
            f"{k}={v!r}" for k, v in extra.items()))
    result = {"correct": bool(correct), "attempted": res["attempted"],
              "failed": res["failed"]}
    metrics = {}
    view = _RunView(res, ctx, cfg)
    for m in common.metrics_of(man, workload["name"], trace):
        if trace:
            value = common.reader(m["name"]).read(view)
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        elif m["name"] == "peak_mem_gib":
            value = res["peak"] / common.GIB if device.type == "cuda" \
                else None
        else:
            # ``<quantity>.<qualifier>`` is the quantity under a bound of
            # its own (``train_ms.vov99``: a device-paced step)
            value = res["e2e"].get(m["name"].split(".", 1)[0])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = common.device_info(torch, device, chips, res["peak"])
    prof = res["layer"].get("profile")
    if trace and prof is not None:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in rows}
    return result


class _RunView:
    """What a per-layer reader sees of a traced run."""

    def __init__(self, res, ctx, cfg):
        self.layer = res["layer"]
        self.window_s = res["window_s"]
        self.units = res["units"]
        self.peaks = ctx.peaks
        self.chips = ctx.chips
        self.cfg = cfg


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    from harness import common
    man = common.manifest(ROOT)
    workload = common.workload(man, args.workload)
    entry = common.config_entry(man, workload["config"])
    cfg = common.load_json(os.path.join(ROOT, entry["file"]))
    params = common.load_json(common.traffic_path(workload["traffic"]))
    limits = common.load_json(common.limits_path(workload["name"]))
    result = run_cell(workload, cfg, params, limits, man, args.seed,
                      args.seconds, bool(args.trace), args.control)

    found = common.forbidden_loaded()
    if found:
        common.log("run.py: forbidden modules loaded in this process: "
                   + ", ".join(found))
        return 3
    power = common.power_limit()
    if power:
        common.log(f"card: {power}")
    common.log(f"correct: {result['correct']}")
    for name, c in result["compared"].items():
        common.log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
