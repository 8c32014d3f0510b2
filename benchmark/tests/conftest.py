"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``). Tests that need a card carry the ``card`` marker and
ask for the ``card`` fixture, which skips them where no CUDA device is
present; the decision is taken inside the fixture, never at import."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH, os.path.dirname(os.path.abspath(__file__))):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (runs on the chip; skipped "
        "here)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda", 0)
