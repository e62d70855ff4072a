"""Test settings of the benchmark's own tests.

``chip``: a test that needs a CUDA card.  Whether there is one is
decided inside the ``cuda`` fixture, never while a module is imported,
so every test worker collects the same tests.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
