"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
checkout's root. Tests that need a CUDA card carry the ``pbcard`` marker
and skip inside the test when there is none."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "pbcard: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)
