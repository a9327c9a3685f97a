"""pytest settings of the benchmark's own tests (``python -m pytest perfbench/tests``).

Tests that need a CUDA card carry the marker ``card``; the ``cuda_device``
fixture skips them where there is none, deciding when the test runs, never
when the module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest perfbench/tests -m card)")
    return torch.device("cuda", 0)
