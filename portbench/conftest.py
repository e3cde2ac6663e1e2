"""Pytest settings of the benchmark's own tests.

    python -m pytest portbench -q

Tests that need a CUDA card carry the ``chip`` marker and skip, inside the
``cuda`` fixture, where there is none; on the card machine the same
command runs them.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
