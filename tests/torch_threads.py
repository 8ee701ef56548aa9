"""One torch intra-op thread for the port's CPU test modules.

The suite runs test files in parallel worker processes, and each
process's torch thread pool is as wide as the machine: together they
oversubscribe the cores, and each parallel region waits for threads that
are not running. A module imports ``one_torch_thread`` (an autouse
fixture) to run its tests on one thread, restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
