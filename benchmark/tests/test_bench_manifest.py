"""BENCHMARK.json against the contract it is written to, and every entry
resolved to its files by name."""

import os
import re

import pytest

from harness import common

MAN = common.manifest(common.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["reduced"] == []
    assert entry["file"].startswith("benchmark/configs/")
    cfg = common.load_json(os.path.join(common.ROOT, entry["file"]))
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == [] and cfg["assumed"]
    assert cfg["model"]["type"] == "SparseBEV"
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    common.config_entry(MAN, w["config"])
    params = common.load_json(common.traffic_path(w["traffic"]))
    assert os.path.exists(os.path.join(common.BENCH_DIR, "harness",
                                       params["driver"] + ".py"))
    limits = common.load_json(common.limits_path(w["name"]))
    assert limits and all(v >= 0 for v in limits.values())
    e2e = common.metrics_of(MAN, w["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert common.metrics_of(MAN, w["name"], trace=True)


def test_metrics():
    seen = set()
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        assert hasattr(common.reader(m["name"]), "read")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_named_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert set(by_layer) == {"streaming loop", "frame pass", "head",
                             "kernels", "device", "whole sample",
                             "whole step"}
