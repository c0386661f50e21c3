"""One intra-op thread for the port's CPU tests.

The port's CPU path is many small torch ops. With torch's default of one
OpenMP thread a core, each parallel region waits on threads the scheduler
has parked when the suite's workers load every core, and those tests ran
an order of magnitude slower than alone; with one thread they do not. A
test module imports ``one_torch_thread`` (autouse, module scope, so its
module fixtures run under it too); the count is restored after.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
