"""pytest settings of the benchmark's own tests (``benchmarks/tests``):

    python -m pytest benchmarks/tests -q

The ``chip`` marker is for tests that need a CUDA card; they skip inside
the ``cuda`` fixture where there is none, and run on the card with
``python -m pytest benchmarks/tests -q -m chip``."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    return torch.device("cuda")
