"""Each cell's control comes out not correct: the reference one precision
step below the configuration's, in the program's place, held to the
cell's checks.  On the CPU at the test sizes; on the card (``chip``) at
the cell's own size, three seeds each:
``python -m pytest -q -m chip bench/tests/test_bench_control.py``."""

import pytest

from bench.calibrate import control

CELLS = ["vgg11-radix4.offline-b64", "glm4-9b-radix4.long-prompt"]


def failed(checks):
    return [name for name, (value, limit) in checks.items()
            if not value <= limit]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_control_fails_at_test_size(cell, seed):
    assert failed(control(cell, seed, device="cpu", smoke=True))


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 501, 2 ** 31 + 502,
                                  2 ** 31 + 503])
def test_control_fails_at_cell_size(cuda, cell, seed):
    assert failed(control(cell, seed, device=str(cuda)))
