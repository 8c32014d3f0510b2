"""The lower-precision controls fail the comparison at a size a test run
holds: the stream with the port's own e4m3 level-0 ring against the bf16
reference, and the training step of the reference with its tables rounded
through e4m3 in the program's place. On the chip the same controls run at
the cells' own sizes: ``python3 benchmark/run.py --workload <cell> --seed
<n> --seconds 5 --control <fp8l0 | fp8tables>`` (PERF.md gives the
readings)."""

from tiny import run_tiny


def test_stream_fp8_ring_fails():
    res = run_tiny("vov99.stream", seconds=0.2, control="fp8l0")
    assert res["correct"] is False


def test_train_fp8_tables_fail():
    res = run_tiny("r101.train", seconds=0.2, control="fp8tables")
    assert res["correct"] is False
