"""CPU tests of the benchmark; the tests marked `card` need a CUDA card
and skip without one."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
