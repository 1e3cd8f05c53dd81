"""The benchmark's own tests: on the CPU, except those marked ``cuda``,
which skip without a card. Run from the repository's root:

    python -m pytest streambench/tests -q

They import neither JAX nor the JAX package."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none"
    )


@pytest.fixture
def card():
    """Skip the test where there is no CUDA card (decided inside the
    test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
