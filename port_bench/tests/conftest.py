"""Tests of the port's benchmark.  Those that need the card carry the
`card` marker and skip inside the `card` fixture when no CUDA device is
present (never while a module is imported)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one); run on the "
        "card with `python -m pytest port_bench/tests -m card`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the comparison at the cell's size "
                    "runs on the card")
    return torch.device("cuda")
