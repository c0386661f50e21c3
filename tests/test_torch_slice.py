"""The port's slot-mode main path end to end against the reference, and
the port's boundaries: state carried across, devices, imports.

Tolerance: average rewards within rtol 1e-4, the bar chip_smoke.py holds
the card's Fig. 2 run to (float32 rounding in another order moves a
trajectory's mean by ~1e-7 relative on the CPU).
"""
import ast
import pathlib
import types

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.sched import simulator as jsim
from repro.sched import trace as jtrace
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import ogasched as tog
from repro_torch.core import regret as tregret
from repro_torch.sched import simulator as tsim
from repro_torch.sched import trace as ttrace

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(T=64, L=6, R=16, K=4, seed=1)


@pytest.mark.parametrize("with_regret", [False, True], ids=["rewards", "regret"])
def test_run_all_matches_reference(with_regret):
    want = jsim.run_all(jtrace.TraceConfig(**CFG), with_regret=with_regret)
    got = tsim.run_all(ttrace.TraceConfig(**CFG), with_regret=with_regret, device="cpu")
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name].avg_reward, want[name].avg_reward,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got[name].cumulative, want[name].cumulative, rtol=1e-4)
        assert got[name].rewards.shape == (CFG["T"],)
    gaps_t = tsim.improvement_over_baselines(got)
    gaps_j = jsim.improvement_over_baselines(want)
    assert list(gaps_t) == list(gaps_j)
    for name in gaps_j:
        np.testing.assert_allclose(gaps_t[name], gaps_j[name], rtol=1e-3, atol=1e-3)
    if with_regret:
        res_t, res_j = got["ogasched"], want["ogasched"]
        np.testing.assert_allclose(res_t.regret, res_j.regret, rtol=1e-3)
        np.testing.assert_allclose(res_t.regret_bound, res_j.regret_bound, rtol=1e-6)
        assert res_t.regret <= res_t.regret_bound
    else:
        assert got["ogasched"].regret is None


def test_spec_from_reference_round_trips():
    jspec = jtrace.build_spec(jtrace.TraceConfig(**CFG))
    tspec = convert.spec_from_reference(jspec, "cpu")
    for f in tspec.FIELDS:
        want = np.asarray(getattr(jspec, f))
        got = getattr(tspec, f).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    tspec.validate()
    # any object with the six attributes, e.g. plain numpy
    ns = types.SimpleNamespace(**{f: np.asarray(getattr(jspec, f)) for f in tspec.FIELDS})
    again = convert.spec_from_reference(ns, "cpu")
    for f in tspec.FIELDS:
        assert torch.equal(getattr(again, f), getattr(tspec, f))


def test_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch):
    """No ``device=`` means the CUDA card; without one every entry point
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttrace.TraceConfig(T=4, L=3, R=4, K=2)
    spec, arr = ttrace.make(cfg, device="cpu")
    calls = [
        lambda: ttrace.make(cfg),
        lambda: ttrace.make_batch([cfg]),
        lambda: tsim.run_all(cfg),
        lambda: tog.run(spec, arr, eta0=1.0),
        lambda: tog.run_batch(ttrace.make_batch([cfg], device="cpu")[0],
                              arr[None], 1.0, 0.99),
        lambda: tbase.run(spec, arr, "drf"),
        lambda: tregret.offline_optimum(spec, arr, iters=2),
        lambda: convert.spec_from_numpy(*(np.zeros(1),) * 6),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_paths_say_so():
    """The job lifecycle and the size-aware baselines are ported now: they
    run (tests/test_torch_lifecycle.py and test_torch_hesrpt.py hold them
    to the reference); a fault stream in slot mode still raises."""
    cfg = ttrace.TraceConfig(T=4, L=3, R=4, K=2)
    res = tsim.run_all(cfg, mode="lifecycle", device="cpu")
    assert all(r.lifecycle is not None and r.rewards.shape == (4,) for r in res.values())
    res = tsim.run_all(cfg, algorithms=("hesrpt", "multiclass"), device="cpu")
    assert all(r.lifecycle is None and np.isfinite(r.rewards).all() for r in res.values())
    with pytest.raises(ValueError, match="mode"):
        tsim.run_all(cfg, mode="stream", device="cpu")
    with pytest.raises(ValueError):
        tsim.run_all(ttrace.TraceConfig(T=4, L=3, R=4, K=2,
                                        faults=ttrace.FaultConfig(fail_rate=0.1)),
                     device="cpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_reference():
    files = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("*.py")))
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
