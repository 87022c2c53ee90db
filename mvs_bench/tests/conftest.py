"""The benchmark's own tests: ``python -m pytest mvs_bench/tests -q -p
no:cacheprovider`` from the repository's root (the ``gpu``-marked ones run
on a card and skip without one)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skipped without one)")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
