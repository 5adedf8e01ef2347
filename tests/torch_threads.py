"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs in several worker processes (pytest-xdist), and PyTorch
gives each process one intra-op thread per core, so the workers
oversubscribe the cores.  The plain versions issue many small ops, each
parallel region waits for all its threads, so under six workers a file
of them ran tens of times slower than alone.  A test module imports
``one_torch_thread``; its tests then run on one thread, and the count
is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
