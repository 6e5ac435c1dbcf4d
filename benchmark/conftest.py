"""pytest settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

Tests marked ``chip`` need a CUDA card: they take the ``cuda`` fixture, which
decides inside the test whether there is one and skips otherwise.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
