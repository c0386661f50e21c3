import os
import sys

import pytest

# Tests run against 1 CPU device (dry-run sets its own 512-device flag in a
# subprocess). A handful of distributed tests request 8 devices explicitly
# via their own module-level guard BEFORE jax initialises; see
# tests/test_distributed.py which must run in a separate process when needed.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "sanitized: run under jax.transfer_guard('disallow') and "
        "jax.checking_leaks() — the runtime face of repro.analysis.lint",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc (the port's kernels); skips with a "
        "reason on a host without them",
    )
    config.addinivalue_line(
        "markers",
        "torch_sanitized: a port path run under repro_torch.compat.sync_guard "
        "(a host sync on a CUDA tensor raises)",
    )


@pytest.fixture(autouse=True)
def _runtime_sanitizers(request):
    """Wrap @pytest.mark.sanitized tests in jax's runtime guards.

    transfer_guard("disallow") turns any *implicit* host<->device transfer
    into an error (explicit device_put/jnp.asarray/device_get stay legal);
    checking_leaks errors on tracers escaping their trace. Both degrade to
    no-ops on jax versions lacking the APIs (see repro.compat).
    """
    if request.node.get_closest_marker("sanitized") is None:
        yield
        return
    from repro import compat

    with compat.transfer_guard("disallow"), compat.checking_leaks():
        yield


@pytest.fixture
def compile_counter():
    """Factory for repro.compat.CompilationCounter context managers."""
    from repro import compat

    return compat.CompilationCounter
