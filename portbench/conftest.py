"""pytest settings of the benchmark's own tests (`python -m pytest
portbench`): the `cuda` marker, and a fixture that skips a test where no
card is present (decided when the test runs, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
