"""pytest settings of the benchmark's own tests (``python3 -m pytest
cardbench/tests``): the ``card`` marker, for tests that need a CUDA card.
They decide whether there is one inside the ``card`` fixture, never at
import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python3 -m pytest cardbench/tests -m card")
    return torch.device("cuda")
