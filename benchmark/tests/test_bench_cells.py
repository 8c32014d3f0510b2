"""Each cell end to end at a tiny size on the CPU, through the drivers and
the port's CPU path (plain versions of the kernels): the result object has
exactly the keys the contract fixes, and the port meets the reference."""

import json

import pytest
from tiny import run_tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def _check_line(res, e2e):
    line = json.loads(json.dumps(res))
    assert set(line) == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == set(e2e)
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]


def test_stream_cell_on_cpu():
    # peak_mem_gib is a card's reading: a CPU run leaves it out
    _check_line(run_tiny("vov99.stream", seconds=0.3),
                ["stream_ms", "stream_p95_ms", "setup_s"])


@pytest.mark.parametrize("workload,e2e", [
    ("r101.train", ["train_ms", "setup_s"]),
    ("vov99.train", ["train_ms.vov99", "setup_s"])])
def test_train_cell_on_cpu(workload, e2e):
    _check_line(run_tiny(workload, seconds=0.3), e2e)
