"""On the card: one short run of a cell as the driver starts it, whose last
line parses and reads ``correct``. Run on the chip with ``python -m pytest
benchmark/tests -m card``."""

import json
import subprocess
import sys

import pytest

from harness import common


@pytest.mark.card
def test_stream_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vov99.stream",
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu"
