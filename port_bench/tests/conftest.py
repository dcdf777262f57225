"""Tests of the benchmark harness: CPU tests at tiny sizes, and tests marked
``gpu`` that need the card and skip without one (decided in a fixture)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
