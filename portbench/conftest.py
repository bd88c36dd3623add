"""pytest settings of the benchmark's own tests (``python -m pytest
portbench -q`` from the root of a checkout)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100 machine")
    return torch.device("cuda")
