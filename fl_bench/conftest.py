"""pytest settings of the benchmark's tests: the ``card`` marker, and the
``card`` fixture that skips a test where no CUDA card is visible (decided
when the test runs, never while a module is imported). The tests import
the harness's modules from this directory and the program from
``src/``."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")
