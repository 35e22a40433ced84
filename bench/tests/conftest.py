"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
root of the checkout.  Tests marked ``chip`` need the card and skip
without one; the others run on the CPU at the configurations' test
sizes (``"smoke"`` in each file)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")
