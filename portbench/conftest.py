"""pytest settings of the port bench's own tests (portbench/tests):

    python -m pytest portbench/tests -q

Tests that need a CUDA card carry the ``card`` marker and skip without one;
the card is looked for inside the ``card`` fixture, never at import."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port bench measures the card only")
    return torch.device("cuda")
