"""pytest settings of the benchmark's own tests (``python -m pytest gpubench``).

``cuda`` marks a test that needs the card; the ``card`` fixture decides
inside the test whether there is one, and skips it here otherwise.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
