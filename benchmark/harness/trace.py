"""Tracing from the benchmark's own files: spans around the port's calls
(wrapped from outside, on the model instance or as module attributes, for
the length of a run), kernel-call records for the roofline counters, and
the reading of a ``torch.profiler`` trace of a short sub-window.

Nothing here runs in an untraced run: the drivers install it only with
``--trace 1``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from .common import BENCH_DIR, load_module


def patch_attr(patches: list, owner, name: str, make: Callable):
    """Replace ``owner.name`` by ``make(original)``; ``patches`` collects
    what :func:`unpatch` puts back (an instance attribute that only shadowed
    its class's method is deleted again)."""
    orig = getattr(owner, name)
    patches.append((owner, name, orig, name in vars(owner)))
    setattr(owner, name, make(orig))
    return orig


def unpatch(patches: list) -> None:
    for owner, name, orig, own in reversed(patches):
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)
    patches.clear()


class EventSpans:
    """CUDA-event spans: ``begin(name)`` / ``end(name)`` record an event pair
    on the current stream; :meth:`ms` sums each span's device time after a
    synchronize. Spans may overlap across names, not within one."""

    def __init__(self, torch):
        self.torch = torch
        self.open: Dict[str, object] = {}
        self.pairs: Dict[str, List[Tuple[object, object]]] = {}

    def begin(self, name: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.open[name] = ev

    def end(self, name: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.setdefault(name, []).append((self.open.pop(name), ev))

    def total_ms(self, name: str) -> Optional[float]:
        pairs = self.pairs.get(name)
        if not pairs:
            return None
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs)

    def count(self, name: str) -> int:
        return len(self.pairs.get(name, ()))


# ---------------------------------------------------------------- kernels


def kernel_counters() -> Dict[str, object]:
    """Every counter file under ``benchmark/kernels/``, by kernel name."""
    kdir = os.path.join(BENCH_DIR, "kernels")
    out = {}
    for fn in sorted(os.listdir(kdir)):
        if fn.endswith(".py") and not fn.startswith("_"):
            name = fn[:-3]
            out[name] = load_module(os.path.join(kdir, fn),
                                    "bench_kernel_" + name)
    return out


class KernelCalls:
    """Records the operands of each counted kernel's calls while
    ``active``: each counter file names the port function that launches its
    kernel (``HOOK = (module, attribute)``); the wrapper keeps what
    ``record(args, result)`` returns."""

    def __init__(self, counters: Dict[str, object]):
        self.counters = counters
        self.calls: Dict[str, list] = {n: [] for n in counters}
        self.active = False
        self.patches: list = []

    def install(self) -> None:
        for name, mod in self.counters.items():
            owner = importlib.import_module(mod.HOOK[0])

            def make(orig, name=name, mod=mod):
                def wrapped(*args, **kwargs):
                    out = orig(*args, **kwargs)
                    if self.active:
                        self.calls[name].append(mod.record(args, out))
                    return out
                return wrapped

            patch_attr(self.patches, owner, mod.HOOK[1], make)

    def remove(self) -> None:
        unpatch(self.patches)

    def bounds(self, peak: dict) -> Dict[str, float]:
        """Each kernel's summed roofline bound in seconds over the recorded
        calls: per call the larger of operations over the peak rate of the
        counter's ``RATE`` and bytes over the memory bandwidth."""
        out = {}
        for name, calls in self.calls.items():
            if not calls:
                continue
            mod = self.counters[name]
            total = 0.0
            for rec in calls:
                flops, nbytes = mod.count(rec)
                total += max(flops / peak[mod.RATE],
                             nbytes / peak["hbm_bytes_per_s"])
            out[name] = total
        return out


# ---------------------------------------------------------------- profiler


@contextlib.contextmanager
def profiled(torch):
    """``torch.profiler`` over CPU and CUDA; yields a holder whose ``trace``
    is the parsed chrome trace (a list of events) and ``wall_s`` the host
    time between the synchronizes at both ends, once the block has run."""
    from torch.profiler import ProfilerActivity, profile
    holder = type("Profiled", (), {})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield holder
        torch.cuda.synchronize()
        holder.wall_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace) -> List[dict]:
    return [e for e in trace if e.get("ph") == "X"
            and e.get("cat") in _DEVICE_CATS]


def busy_intervals(events) -> List[Tuple[float, float]]:
    """The union of the device events' intervals (us), sorted."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def kernel_seconds(events, needle: str) -> float:
    """Device seconds of the kernels whose name holds ``needle``."""
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel" and needle in e["name"]) / 1e6


def summarize(trace, wall_s: float, top: int = 10) -> dict:
    """busy seconds, the traced window, the idle share, the device ops that
    took most time and the longest idle gaps named by the innermost
    benchmark span (``bench.*`` annotations) or host op that covers them."""
    dev = device_events(trace)
    busy = busy_intervals(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in trace if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        cover = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        ann = [e for e in cover if e.get("cat") == "user_annotation"]
        pick = min(ann or cover, key=lambda e: e["dur"], default=None)
        named.append([pick["name"][:80] if pick else "host (no op)",
                      (b - a) / 1e6])
    return {"busy_s": busy_s, "window_s": wall_s,
            "idle_pct": 100.0 * max(0.0, 1.0 - busy_s / wall_s),
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": named, "events": dev}


def annotate(patches: list, owner, name: str, label: str):
    """Wrap ``owner.name`` in a ``record_function`` span named ``label``."""
    from torch.profiler import record_function

    def make(orig):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return orig(*args, **kwargs)
        return wrapped

    patch_attr(patches, owner, name, make)
