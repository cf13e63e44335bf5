"""One torch thread for the port's CPU tests.

Tier 1 runs several pytest workers on the host's cores, and each torch
process starts an intra-op thread pool as wide as the host.  The plain
versions' many small ops then oversubscribe the cores: a CPU train step at
tests/test_train.py::tiny_cfg sizes took 6 min 43 s with five other busy
processes on 8 cores, and 22 s with one torch thread.  Import the fixture
into a test module to run its tests single-threaded; the previous count is
restored after each test.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
