"""Tests of the benchmark.  Card-only tests carry the ``cuda`` marker and
take the ``cuda_device`` fixture, which skips them without a card; the
choice is made inside the fixture, never at import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without them")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs at the cells' "
                    "full size on the card)")
    return "cuda"
