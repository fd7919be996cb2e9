"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on one host, and each torch
process starts as many OpenMP threads as the host has cores. On the port's
many small ops the pools of the workers spin against each other: on an
8-core host, three tests of ``tests/test_torch_deep.py`` took 418 s in each
of six concurrent runs with the default pool, and 12 s with one thread.

A test module that runs torch on the CPU imports :func:`one_torch_thread`,
which holds torch at one thread for the module and then restores the pool.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
