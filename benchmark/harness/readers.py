"""The per-layer readers that metrics share by the first dotted part of
their name (a metric with a file ``benchmark/metrics/<metric>.py`` reads
through that file instead). A reader returns None when its run holds
nothing to read; the metric is then left out of the result line."""

from __future__ import annotations

import types
from typing import Optional

from . import trace

_DTYPE_PEAK = {"bfloat16": "bf16_flops_per_s", "float32": "fp32_flops_per_s"}


def roofline(run, kernel: str) -> Optional[float]:
    """100 x the kernel's summed roofline bound over its summed device time
    in the profiled sub-window (``benchmark/kernels/<kernel>.py`` counts the
    bound's operations and bytes from each call's operands)."""
    prof = run.layer.get("profile")
    bound = run.layer.get("kernel_bounds", {}).get(kernel)
    if prof is None or not bound:
        return None
    needle = trace.kernel_counters()[kernel].KERNEL
    seconds = trace.kernel_seconds(prof["events"], needle)
    return 100.0 * bound / seconds if seconds > 0 else None


def idle_pct(run) -> Optional[float]:
    """Share of the profiled sub-window in which no kernel, copy or memset
    ran on the card."""
    prof = run.layer.get("profile")
    return None if prof is None else prof["idle_pct"]


def mfu(run) -> Optional[float]:
    """100 x the model FLOPs of the timed window's samples or steps over the
    window's wall time and the dense peak of the configuration's compute
    dtype, times the cell's cards."""
    flops = run.layer.get("model_flops")
    if not flops or not run.window_s or not run.peaks:
        return None
    dtype = run.cfg["model"].get("compute_dtype", "bfloat16")
    peak = run.peaks[_DTYPE_PEAK[dtype]] * run.chips
    return 100.0 * flops * run.units / run.window_s / peak



def shared(stem: str):
    """The reader of every metric whose name starts ``<stem>.``:
    ``<kernel>_roofline`` (a kernel with a counter in
    ``benchmark/kernels/``), ``idle_pct`` or ``mfu``."""
    if stem.endswith("_roofline") and \
            stem[:-len("_roofline")] in trace.kernel_counters():
        kernel = stem[:-len("_roofline")]
        return types.SimpleNamespace(read=lambda run: roofline(run, kernel))
    if stem in ("idle_pct", "mfu"):
        return types.SimpleNamespace(read=globals()[stem])
    raise KeyError(f"no reader for {stem!r}: add benchmark/metrics/"
                   f"<metric>.py")
