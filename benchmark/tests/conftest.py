"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository root. They import the harness (``benchmark/``) and the program
from the checkout; those that need the card are marked ``cuda`` and skip
without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: parallel workers' pools would spin against
    each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
