"""Tests of the benchmark harness: ``python -m pytest port_bench/tests``.
Tests that need a CUDA card are marked ``gpu`` and skip (in a fixture)
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
