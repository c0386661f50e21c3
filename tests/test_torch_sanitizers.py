"""Runtime sanitizers of the port (``repro_torch.compat``), the counterpart
of ``tests/test_sanitizers.py``.

The four paths the reference runs under ``transfer_guard("disallow")``
(the reward gradient, the projection's capacity fill, ``ogasched.run`` and
the regret curve) run here under ``compat.sync_guard("error")``, which on
a CUDA tensor raises at any operation that makes the host wait for the
card, and under ``NoHostSync``, which raises at the operations that would
(a scalar read, ``nonzero``, a boolean mask) on any device, so the paths
are held on this CPU too. Inputs are staged before the guards, results
read back after them, as the reference stages and ``device_get``s.
``tests/test_torch_cuda.py`` runs the same paths on the card.

``CompilationCounter`` counts ``kernels.build.build``'s nvcc runs. Its
contract is held with a stand-in compiler that writes its output file
(the real nvcc on the card: ``tests/test_torch_cuda.py``), and skips
where the real one is needed and missing, as the reference's does.
"""
import contextlib
import os
import stat
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import compat
from repro_torch.core import graph, ogasched, projection, regret, reward
from repro_torch.kernels import build
from repro_torch.sched import trace

# operations that read a device value on the host: the host waits there
_SYNC_OPS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
             torch.ops.aten.masked_select, torch.ops.aten.is_nonzero,
             torch.ops.aten.equal}


class NoHostSync(TorchDispatchMode):
    """Raises at an operation that reads a tensor's values on the host, or
    indexes by a boolean mask (a ``nonzero`` inside)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bool_index = func is torch.ops.aten.index.Tensor and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1])
        if func.overloadpacket in _SYNC_OPS or bool_index:
            raise RuntimeError(f"host sync: {func}")
        return func(*args, **kwargs)


@contextlib.contextmanager
def guards():
    with compat.sync_guard("error"), NoHostSync():
        yield


def staged(seed: int, device):
    cfg = trace.TraceConfig(L=4, R=6, K=3, T=12, seed=seed)
    return trace.build_spec(cfg, device), trace.build_arrivals(cfg, device=device), cfg


def stage_all(device) -> dict:
    """The inputs of the four paths, on ``device``, made before any guard."""
    spec0, _, cfg0 = staged(0, device)
    rng = np.random.default_rng(0)
    return {"spec0": spec0, "y0": graph.random_feasible_decision(spec0, rng),
            "x0": torch.from_numpy((rng.random(cfg0.L) < 0.7).astype(np.float32)).to(device),
            "run1": staged(1, device), "run2": staged(2, device),
            "eta": torch.full((), 5.0, device=device), "decay": 0.999,
            "ones": torch.ones(cfg0.L, device=device)}


def path_reward_grad(s):
    spec = s["spec0"]
    return reward.total_reward(spec, s["x0"], s["y0"]), reward.reward_grad(spec, s["x0"], s["y0"])


def path_projection_fill(s):
    spec = s["spec0"]
    z = spec.a[:, None, :] * spec.mask[:, :, None]          # (L, R, K) demand
    L = z.shape[0]
    return projection.fill_rows_to_capacity(
        z.reshape(L, -1),
        spec.a[:, None, :].expand(z.shape).reshape(L, -1),
        spec.mask[:, :, None].expand(z.shape).reshape(L, -1),
        spec.c.sum() * s["ones"] * 0.1)


def path_oga_run(s):
    spec, arrivals, _ = s["run1"]
    return ogasched.run(spec, arrivals, eta0=s["eta"], decay=s["decay"], device=spec.device)


def path_regret_curve(s):
    spec, arrivals, _ = s["run2"]
    rewards, _ = ogasched.run(spec, arrivals, eta0=s["eta"], decay=s["decay"],
                              device=spec.device)
    y_star = regret.offline_optimum(spec, arrivals, iters=16, device=spec.device)
    return regret.regret_curve(spec, arrivals, rewards, y_star)


@pytest.fixture(scope="module")
def cpu_inputs():
    return stage_all("cpu")


@pytest.mark.torch_sanitized
def test_reward_grad_path_clean_under_guards(cpu_inputs):
    with guards():
        q, g = path_reward_grad(cpu_inputs)
    assert np.isfinite(q.numpy()).all() and np.isfinite(g.numpy()).all()


@pytest.mark.torch_sanitized
def test_projection_path_clean_under_guards(cpu_inputs):
    with guards():
        y = path_projection_fill(cpu_inputs)
    y = y.numpy()
    assert np.isfinite(y).all() and (y >= -1e-6).all()


@pytest.mark.torch_sanitized
def test_oga_run_clean_under_guards(cpu_inputs):
    with guards():
        rewards, y_final = path_oga_run(cpu_inputs)
    spec, _, cfg = cpu_inputs["run1"]
    assert rewards.shape == (cfg.T,) and np.isfinite(rewards.numpy()).all()
    assert bool(graph.feasible(spec, y_final))


@pytest.mark.torch_sanitized
def test_regret_curve_path_clean_under_guards(cpu_inputs):
    with guards():
        curve = path_regret_curve(cpu_inputs)
    assert curve.shape == (cpu_inputs["run2"][2].T,) and np.isfinite(curve.numpy()).all()


def test_no_host_sync_catches_scalar_reads_and_masks():
    t = torch.arange(4.0)
    for read in (lambda: float(t.sum()), lambda: t[t > 1], lambda: t.nonzero(),
                 lambda: bool(t.any())):
        with pytest.raises(RuntimeError, match="host sync"), NoHostSync():
            read()
    with NoHostSync():
        assert t.sum().shape == ()


def test_sync_guard_is_a_null_context_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds the guard there")
    assert isinstance(compat.sync_guard("error"), contextlib.nullcontext)
    with compat.sync_guard():
        float(torch.ones(()))


# ------------------------------------------------------ compilation counter --
FAKE_NVCC = """#!{python}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").close()
"""


def test_compilation_counter_counts_each_source_compiled(tmp_path, monkeypatch):
    """A stand-in nvcc (it writes the library file it is asked for):
    a cold build compiles every source, one nvcc each; a warm one none;
    an edited source all of them again (the libraries are named by a hash
    of every source)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.SOURCES:
        (csrc / src).write_text("// stand-in\n")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
    monkeypatch.setattr(compat, "nvcc_path", lambda: str(nvcc))
    before = compat.backend_compile_count()
    with compat.CompilationCounter() as cold:
        built = build.build()
    assert cold.supported and cold.count == len(build.SOURCES) == len(built)
    with compat.CompilationCounter() as warm:
        assert build.build() == {}
    assert warm.count == 0
    (csrc / build.SOURCES[0]).write_text("// edited\n")
    with compat.CompilationCounter() as edited:
        build.build()
    assert edited.count == len(build.SOURCES)
    assert compat.backend_compile_count() - before == 2 * len(build.SOURCES)
    assert all(os.path.exists(build.library_path(s)) for s in build.SOURCES)


def test_compilation_counter_with_the_real_compiler():
    """A warm ``build()`` of the checkout's sources compiles nothing."""
    with compat.CompilationCounter() as c:
        pass
    if not c.supported:
        pytest.skip("no nvcc: the CUDA sources cannot be compiled here")
    build.build()
    with compat.CompilationCounter() as warm:
        build.build()
    assert warm.count == 0
