"""pytest settings for the benchmark's own tests (``fluidbench/tests``).

Tests that need an NVIDIA card carry the ``card`` marker and take the
``card`` fixture, which decides at run time, never at import, and skips
with its reason where there is none.  On the card:
``python3 -m pytest fluidbench/tests -q -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
