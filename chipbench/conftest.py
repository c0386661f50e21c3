"""Settings of the benchmark's own tests, which a bare ``python -m pytest``
from the root collects: the ``cuda`` marker (tests that need the card
decide inside a fixture and skip here), and one intra-op torch thread a
module, since the suite's workers load every core."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc (the port's kernels); skips with a "
        "reason on a host without them",
    )


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
