"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of a checkout.  Tests marked ``cuda`` need an NVIDIA GPU and skip
without one, deciding inside the test."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with its reason without one")


@pytest.fixture
def card():
    """Skip unless torch sees a GPU (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return "cuda"
