"""On the card, at each cell's own size: the program's check passes and its
control fails, on three seeds (``perfbench/calibrate.py``'s readings).
Marked ``cuda``; skips without a card.  Run on the card with
``python -m pytest -q -m cuda perfbench/tests/test_perfbench_cuda.py``."""
import pytest
import torch

import pbsetup
from perfbench.bench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(card, cell):
    import sys

    sys.path.insert(0, str(pbsetup.ROOT / "perfbench"))
    try:
        import calibrate
    finally:
        sys.path.remove(str(pbsetup.ROOT / "perfbench"))
    seeds = [101, 102, 103]
    for rec in calibrate.readings(cell, seeds, seeds, card, log=lambda s: None):
        failed = [c["name"] for c in rec["checks"] if c["value"] > c["limit"]]
        assert bool(failed) == rec["control"], rec
