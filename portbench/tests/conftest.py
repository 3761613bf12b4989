"""Tests of the benchmark harness.  They import no JAX.  Tests that need an
NVIDIA card carry the ``card`` marker and decide in the ``card`` fixture,
never while a module is imported, whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 -m pytest portbench/tests -m card)")
    return torch.device("cuda:0")
