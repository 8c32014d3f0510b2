"""Spans at the port's layer boundaries, on the host's and the card's clocks.

Off by default, and nothing in the package switches it on: a script (the
benchmark, an operator's) calls :func:`enable`. While off, :func:`span`
reads one module global and returns a shared null context: it records
nothing, creates no CUDA event and enters no profiler range.

While on, each span records its name, the span open around it on the same
thread (its parent), a request id (a root span opens a new one, its children
inherit it: one streaming call or one training step is one request), its
host start and end (``time.perf_counter_ns``) and, where CUDA is available,
a pair of timing events on the current stream. Each span is also a
``torch.profiler.record_function`` range, so a profiled window carries the
spans as ``user_annotation`` events on the profiler's clock, beside the
kernels and copies they launched.

:func:`collect` synchronizes once and sums the records by name: the count,
host ms, device ms (None without CUDA), host self ms (the span's duration
minus the part its child spans cover), the parents' names and the request
ids; then it clears them. Usage::

    from sparsebev_tpu_torch.utils import tracing
    tracing.enable()
    ...                       # streaming calls or training steps
    table = tracing.collect()
    tracing.disable()
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()
_on = False
_cuda = False
_records: List["Record"] = []
_local = threading.local()
_request_ids = itertools.count(1)


class Record:
    """One closed span. ``parent`` is the enclosing span's record (None for
    a root); ``events`` the CUDA start and end events, or None."""

    __slots__ = ("name", "parent", "request", "t0", "t1", "events")

    def __init__(self, name: str, parent: Optional["Record"], request: int,
                 t0: int = 0, t1: int = 0, events=None):
        self.name = name
        self.parent = parent
        self.request = request
        self.t0 = t0
        self.t1 = t1
        self.events = events


def enable() -> None:
    """Start recording (dropping any records left from before)."""
    global _on, _cuda
    _cuda = torch.cuda.is_available()
    _records.clear()
    _on = True


def disable() -> None:
    """Stop recording and drop the records not yet collected."""
    global _on
    _on = False
    _records.clear()


def span(name: str):
    """A context manager around one layer's call (see the module's doc)."""
    if not _on:
        return _NULL
    return _span(name)


@contextlib.contextmanager
def _span(name: str):
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    parent = stack[-1] if stack else None
    rec = Record(name, parent,
                 parent.request if parent else next(_request_ids))
    with torch.profiler.record_function(name):
        if _cuda:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        rec.t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            rec.t1 = time.perf_counter_ns()
            if rec.events is not None:
                rec.events[1].record()
            stack.pop()
            _records.append(rec)


def collect() -> Dict[str, dict]:
    """The closed spans since :func:`enable` or the last call, summed by
    name (:func:`summarize`); the records are then cleared."""
    recs = list(_records)
    _records.clear()
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    return summarize(recs)


def summarize(records: List[Record]) -> Dict[str, dict]:
    """``{name: {count, host_ms, device_ms, self_ms, parents, requests}}``:
    ``device_ms`` is None unless every span of the name has events;
    ``parents`` and ``requests`` are sorted lists of the distinct parent
    names (None for a root) and request ids."""
    covered = {id(r): 0 for r in records}
    for r in records:
        p = r.parent
        if p is not None and id(p) in covered:
            covered[id(p)] += max(0, min(r.t1, p.t1) - max(r.t0, p.t0))
    out: Dict[str, dict] = {}
    for r in records:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "device_ms": 0.0, "self_ms": 0.0,
                                    "parents": set(), "requests": set()})
        s["count"] += 1
        s["host_ms"] += (r.t1 - r.t0) / 1e6
        s["self_ms"] += (r.t1 - r.t0 - covered[id(r)]) / 1e6
        if r.events is None or s["device_ms"] is None:
            s["device_ms"] = None
        else:
            s["device_ms"] += r.events[0].elapsed_time(r.events[1])
        s["parents"].add(r.parent.name if r.parent else None)
        s["requests"].add(r.request)
    for s in out.values():
        s["parents"] = sorted(s["parents"], key=lambda n: (n is not None, n))
        s["requests"] = sorted(s["requests"])
    return out
