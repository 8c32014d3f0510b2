"""The port's own spans in a traced run: its tracer
(``sparsebev_tpu_torch/utils/tracing.py``) switched on for the timed window
and the profiled sub-window after it, its sums read after the window, and
the device's idle time under each span of the sub-window's
``torch.profiler`` trace, where the spans are ``user_annotation`` events on
the kernels' clock.

The drivers do not call this module yet: switching the tracer on takes
lines in the ``--trace 1`` branches of ``harness/stream.py`` and
``harness/train.py``, and the metrics that would read the spans
(``per_unit``, ``idle_per_unit``) need entries in ``BENCHMARK.json``;
``PERF.md`` (open questions) gives both.

A port without the tracer has nothing to switch on: the functions then do
nothing, and a metric that read the spans would be left out of the result
line.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import trace
from .common import log

PREFIXES = ("stream.", "train.")


def _tracer():
    try:
        from sparsebev_tpu_torch.utils import tracing
    except ImportError:     # a port that has no tracer
        return None
    return tracing


def enable() -> None:
    tracer = _tracer()
    if tracer is not None:
        tracer.enable()


def disable() -> None:
    tracer = _tracer()
    if tracer is not None:
        tracer.disable()


def collect() -> Optional[Dict[str, dict]]:
    """The tracer's sums by span name since :func:`enable` (None without a
    tracer)."""
    tracer = _tracer()
    return None if tracer is None else tracer.collect()


def alloc_retries(torch) -> Optional[int]:
    """The caching allocator's count of allocations retried after freeing
    its cache (None off a card)."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_stats().get("num_alloc_retries", 0))


def log_table(table, unit: str, root: str, window_ms: float) -> None:
    """Each span's count, host, device and host self ms a ``unit`` (one
    ``root`` span), and the root's children's device ms together against
    the window's ms a unit."""
    if not table or root not in table:
        return
    n = table[root]["count"]
    for name, s in sorted(table.items()):
        dev = s["device_ms"]
        log(f"span {name}: {s['count'] / n:g} a {unit}; host "
            f"{s['host_ms'] / n:.3f} ms, device "
            f"{'-' if dev is None else f'{dev / n:.3f}'} ms, self "
            f"{s['self_ms'] / n:.3f} ms a {unit}")
    parts = [s["device_ms"] for s in table.values()
             if s["parents"] == [root]]
    if parts and None not in parts:
        log(f"spans: {root}'s children together {sum(parts) / n:.3f} "
            f"device ms a {unit}, window {window_ms:.3f} ms a {unit}")


# ---------------------------------------------------------------- the trace


def program_events(events) -> List[dict]:
    """The port's spans in a chrome trace (host-side annotations)."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIXES)]


def _busy_within(busy: List[Tuple[float, float]], starts: List[float],
                 a: float, b: float) -> float:
    """The part of [a, b] that the sorted, disjoint ``busy`` intervals
    cover."""
    k = max(0, bisect.bisect_right(starts, a) - 1)
    out = 0.0
    while k < len(busy) and busy[k][0] < b:
        out += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
        k += 1
    return out


def idle_under(events, wall_s: float, top: int = 10) -> dict:
    """Device idle time under the port's spans in a profiled trace.

    ``spans``: for each span name its count, summed ms and summed idle ms
    (the spans' intervals less their overlap with the union of kernels,
    copies and memsets). ``idle_ms``: the traced window's wall time less
    the device's busy time; ``idle_under_spans_ms``: the part of it inside
    some span (their union less the busy time there). ``gaps``: the
    ``top`` longest gaps between busy intervals, longest first, each
    ``[ms, holder, first, last]``: the innermost span that holds the whole
    gap, and those that hold its start and its end (None: no span, as
    between two calls)."""
    busy = trace.busy_intervals(trace.device_events(events))
    starts = [a for a, _ in busy]
    prog = program_events(events)
    out: Dict[str, dict] = {}
    for e in prog:
        a, b = e["ts"], e["ts"] + e["dur"]
        s = out.setdefault(e["name"], {"count": 0, "ms": 0.0,
                                       "idle_ms": 0.0})
        s["count"] += 1
        s["ms"] += e["dur"] / 1e3
        s["idle_ms"] += (b - a - _busy_within(busy, starts, a, b)) / 1e3
    under = sum(b - a - _busy_within(busy, starts, a, b)
                for a, b in trace.busy_intervals(prog)) / 1e3
    gaps = sorted(((busy[k][1], busy[k + 1][0])
                   for k in range(len(busy) - 1)),
                  key=lambda g: g[0] - g[1])[:top]

    def innermost(a, b):
        pick = min((e for e in prog
                    if e["ts"] <= a and b <= e["ts"] + e["dur"]),
                   key=lambda e: e["dur"], default=None)
        return pick["name"] if pick else None

    named = [[(b - a) / 1e3, innermost(a, b), innermost(a, a),
              innermost(b, b)] for a, b in gaps]
    busy_ms = sum(b - a for a, b in busy) / 1e3
    return {"spans": out, "idle_ms": 1e3 * wall_s - busy_ms,
            "idle_under_spans_ms": under, "gaps": named}


def log_idle(idle: dict, unit: str, root: str) -> None:
    n = idle["spans"].get(root, {}).get("count", 0)
    if not n:
        return
    for name, s in sorted(idle["spans"].items()):
        log(f"span idle {name}: {s['idle_ms'] / n:.3f} of {s['ms'] / n:.3f}"
            f" ms a {unit}")
    log(f"span idle: {idle['idle_under_spans_ms']:.3f} of "
        f"{idle['idle_ms']:.3f} idle ms in the sub-window under a span; "
        "longest gaps (ms, innermost span holding it): "
        + ", ".join(f"{ms:.3f} {name}" + ("" if name else
                                           f" ({first} -> {last})")
                    for ms, name, first, last in idle["gaps"]))


# ---------------------------------------------------------------- readers


def per_unit(run, name: str, field: str, root: str) -> Optional[float]:
    """The timed window's ``field`` (``host_ms``, ``device_ms``) of span
    ``name`` a ``root`` span (a sample or a step)."""
    table = run.layer.get("program_spans")
    if not table or name not in table or root not in table:
        return None
    value = table[name][field]
    return None if value is None else value / table[root]["count"]


def idle_per_unit(run, name: str, root: str) -> Optional[float]:
    """The device's idle ms under span ``name`` in the profiled sub-window,
    a ``root`` span there."""
    idle = run.layer.get("span_idle")
    if not idle or name not in idle["spans"] or root not in idle["spans"]:
        return None
    return idle["spans"][name]["idle_ms"] / idle["spans"][root]["count"]
