"""``harness/spans.py`` on hand-made chrome traces: the device's idle time
under each of the port's spans, the longest gaps named by the innermost
span that holds them, and the sums a step or a sample that a span metric
would read, which are None for a run whose port has no tracer."""

import sys
import types

import pytest

from harness import spans


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# us: a step 0..1000 with a forward 0..400 (kernels 50..150 and 200..380)
# and losses 400..900 (a memcpy 420..460, the matcher 450..700 with a
# kernel 650..680, a memset 850..870); a harness op 1000..1100 after the
# step and a kernel in it 1010..1020
TRACE = [
    _x("user_annotation", "train.step", 0, 1000),
    _x("user_annotation", "train.forward", 0, 400),
    _x("user_annotation", "train.losses", 400, 500),
    _x("user_annotation", "train.matcher", 450, 250),
    _x("user_annotation", "bench.matcher", 450, 250),
    _x("cpu_op", "aten::mul", 1000, 100),
    _x("gpu_user_annotation", "train.step", 50, 900),
    _x("kernel", "k1", 50, 100),
    _x("kernel", "k2", 200, 180),
    _x("gpu_memcpy", "Memcpy DtoH", 420, 40),
    _x("kernel", "k3", 650, 30),
    _x("gpu_memset", "Memset", 850, 20),
    _x("kernel", "k4", 1010, 10),
]


def test_idle_under_each_span():
    idle = spans.idle_under(TRACE, wall_s=1100e-6)
    got = {n: (s["count"], s["ms"], s["idle_ms"])
           for n, s in idle["spans"].items()}
    assert got == pytest.approx({
        "train.step": (1, 1.0, (1000 - 100 - 180 - 40 - 30 - 20) / 1e3),
        "train.forward": (1, 0.4, (400 - 100 - 180) / 1e3),
        # the memcpy 420..460 overlaps the matcher 450..700 only in part
        "train.losses": (1, 0.5, (500 - 40 - 30 - 20) / 1e3),
        "train.matcher": (1, 0.25, (250 - 10 - 30) / 1e3)})
    busy = 100 + 180 + 40 + 30 + 20 + 10
    assert idle["idle_ms"] == pytest.approx((1100 - busy) / 1e3)
    assert idle["idle_under_spans_ms"] == pytest.approx(
        (1000 - busy + 10) / 1e3)


def test_gaps_named_by_the_innermost_span_that_holds_them():
    idle = spans.idle_under(TRACE, wall_s=1100e-6, top=4)
    # gaps: 460..650 (matcher), 680..850 (losses), 870..1010 (none: it
    # runs past the step's end), 150..200 (forward); 380..420 (the step:
    # it spans forward and losses) is fifth
    ms, names, firsts, lasts = zip(*idle["gaps"])
    assert ms == pytest.approx((0.19, 0.17, 0.14, 0.05))
    assert names == ("train.matcher", "train.losses", None, "train.forward")
    # the second starts in the matcher (to 700); the third starts in the
    # losses (to 900) and ends outside every span
    assert firsts == ("train.matcher", "train.matcher", "train.losses",
                      "train.forward")
    assert lasts == ("train.matcher", "train.losses", None, "train.forward")
    assert spans.idle_under(TRACE, wall_s=1100e-6)["gaps"][4] == \
        [pytest.approx(0.04), "train.step", "train.forward", "train.losses"]


def test_a_trace_without_program_spans():
    plain = [e for e in TRACE if not e["name"].startswith("train.")]
    idle = spans.idle_under(plain, wall_s=1100e-6)
    assert idle["spans"] == {} and idle["idle_under_spans_ms"] == 0
    assert all(gap[1:] == [None, None, None] for gap in idle["gaps"])


def _run(layer):
    return types.SimpleNamespace(layer=layer)


TABLE = {"train.step": {"count": 4, "host_ms": 40.0, "device_ms": 36.0},
         "train.forward": {"count": 4, "host_ms": 8.0, "device_ms": 12.0}}


def test_sums_a_unit():
    run = _run({"program_spans": TABLE,
                "span_idle": spans.idle_under(TRACE, wall_s=1100e-6)})
    assert spans.per_unit(run, "train.forward", "device_ms",
                          "train.step") == 3.0
    assert spans.per_unit(run, "train.forward", "host_ms",
                          "train.step") == 2.0
    assert spans.per_unit(run, "train.backward", "device_ms",
                          "train.step") is None
    assert spans.idle_per_unit(run, "train.matcher", "train.step") == \
        pytest.approx(0.21)


@pytest.mark.parametrize("name, read", [
    ("train.forward", lambda run, name: spans.per_unit(
        run, name, "device_ms", "train.step")),
    ("train.matcher", lambda run, name: spans.idle_per_unit(
        run, name, "train.step")),
    ("stream.upload", lambda run, name: spans.per_unit(
        run, name, "host_ms", "stream.infer")),
    ("stream.head", lambda run, name: spans.idle_per_unit(
        run, name, "stream.infer"))])
def test_nothing_to_read_without_the_tracer(name, read, monkeypatch):
    """A port without ``utils/tracing.py``: nothing to switch on, and no
    span sum to read."""
    import sparsebev_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "sparsebev_tpu_torch.utils.tracing",
                        None)
    assert spans._tracer() is None
    spans.enable()
    table = spans.collect()
    spans.disable()
    plain = [e for e in TRACE if not e["name"].startswith("train.")]
    run = _run({"program_spans": table,
                "span_idle": spans.idle_under(plain, wall_s=1100e-6)})
    assert read(run, name) is None
    assert read(_run({}), name) is None
