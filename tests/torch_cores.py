"""The CPU's cores shared out between the test processes (not collected:
no ``test_`` prefix). The port's test files import ``share_cores``, an
autouse fixture that, for the file's tests, gives PyTorch an equal share of
the cores among the pytest-xdist workers (``PYTEST_XDIST_WORKER_COUNT``):
each worker's intra-op pool would otherwise take every core, and 6 workers'
pools on 8 cores spend most of their time waiting for each other (a subset
of 6 of these files: 466 s with every pool at 8 threads, 103 s at 1). Alone,
a file keeps every core. The thread count changes only the order of some
float sums, which every tolerance here already covers."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
