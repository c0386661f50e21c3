"""The port's resident slot-mode sweep grid against the reference's
``sched.sweep``, on the CPU: ``make_grid``, ``build_batch``, ``run_grid``
and ``summarize`` on a 4-config grid at T = 48.

Tolerances: traces and stacked operands bitwise (both packages generate
them with the same numpy streams); per-slot rewards and averages rtol 1e-5
(float32 arithmetic in another order; the projection is exact in both);
improvement percentages atol 1e-3 points.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.sched import sweep as jsweep
from repro.sched import trace as jtrace
from repro_torch.core import ogasched as tog
from repro_torch.kernels import autotune
from repro_torch.sched import sweep as tsweep
from repro_torch.sched import trace as ttrace

BASE = dict(T=48, L=6, R=16, K=4, seed=1)
AXES = dict(eta0s=(25.0, 5.0), seeds=(1, 2))
RTOL = 1e-5


@pytest.fixture(scope="module")
def grids():
    jpoints = jsweep.make_grid(jtrace.TraceConfig(**BASE), **AXES)
    tpoints = tsweep.make_grid(ttrace.TraceConfig(**BASE), **AXES)
    return jpoints, tpoints


@pytest.fixture(scope="module")
def batches(grids):
    jpoints, tpoints = grids
    return jsweep.build_batch(jpoints), tsweep.build_batch(tpoints, device="cpu")


@pytest.fixture(scope="module")
def results(batches):
    jb, tb = batches
    return jsweep.run_grid(jb), tsweep.run_grid(tb)


def test_make_grid_matches_reference(grids):
    jpoints, tpoints = grids
    assert len(tpoints) == len(jpoints) == 4
    for jp, tp in zip(jpoints, tpoints):
        assert (tp.eta0, tp.decay) == (jp.eta0, jp.decay)
        assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    # axis order, slowest to fastest: eta0, ..., seed
    assert [(p.eta0, p.cfg.seed) for p in tpoints] == [(25.0, 1), (25.0, 2), (5.0, 1), (5.0, 2)]
    many = tsweep.make_grid(ttrace.TraceConfig(**BASE), utilities=("log", "poly"),
                            rhos=(0.5, 0.9), contentions=(1.0, 4.0))
    assert [(p.cfg.utility, p.cfg.rho, p.cfg.contention) for p in many] == [
        (u, r, c) for u in ("log", "poly") for r in (0.5, 0.9) for c in (1.0, 4.0)]


def test_build_batch_matches_reference_bitwise(batches):
    jb, tb = batches
    assert tb.size == jb.size == 4
    for f in tb.spec.FIELDS:
        np.testing.assert_array_equal(getattr(tb.spec, f).numpy(), np.asarray(getattr(jb.spec, f)))
    np.testing.assert_array_equal(tb.arrivals.numpy(), np.asarray(jb.arrivals))
    np.testing.assert_array_equal(tb.eta0.numpy(), np.asarray(jb.eta0))
    np.testing.assert_array_equal(tb.decay.numpy(), np.asarray(jb.decay))
    assert jb.works is None
    assert [p.cfg.seed for p in tb.points] == [p.cfg.seed for p in jb.points]


def test_run_grid_matches_reference(results):
    jres, tres = results
    assert list(tres) == list(jres) == list(tsweep.ALGORITHMS)
    for name, want in jres.items():
        got = tres[name]
        assert got.shape == (4, BASE["T"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, err_msg=name)


def test_summarize_matches_reference(results):
    jres, tres = results
    got, want = tsweep.summarize(tres), jsweep.summarize(jres)
    assert list(got) == list(want)
    for key in want:
        if key.startswith("avg/"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], atol=1e-3, err_msg=key)


def test_grid_rows_match_single_runs(batches, results):
    """Flattening the grid into the kernel's rows does not change a row's
    trajectory: each row equals its config run alone."""
    _, tb = batches
    _, tres = results
    for g in range(tb.size):
        single, _ = tog.run(tb.spec[g], tb.arrivals[g], eta0=tb.points[g].eta0,
                            decay=tb.points[g].decay, device="cpu")
        np.testing.assert_allclose(tres["ogasched"][g].numpy(), single.numpy(), rtol=RTOL)


def test_reference_backend_and_algorithm_order(batches):
    jb, tb = batches
    algorithms = ("spreading", "ogasched")
    got = tsweep.run_grid(tb, algorithms, backend="reference")
    want = jsweep.run_grid(jb, algorithms, backend="reference")
    assert list(got) == list(algorithms)
    for name in algorithms:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL)


def test_tiling_pin_changes_nothing_on_the_cpu(batches, results, monkeypatch):
    """A pinned tiling is execution layout only; on CPU tensors the grid
    never consults the autotune cache."""
    _, tb = batches
    _, tres = results

    def fail(*a, **kw):
        raise AssertionError("resolve called on a CPU tensor")

    monkeypatch.setattr(autotune, "resolve", fail)
    pinned = tsweep.run_grid(tb, ("ogasched",), tiling=autotune.KernelConfig(8, "bisect", 12))
    assert torch.equal(pinned["ogasched"], tres["ogasched"])


def test_unported_and_invalid_grids_raise(grids):
    """Lifecycle grids and size-aware slot grids are ported; a batch
    without job sizes is refused for them."""
    _, tpoints = grids
    assert tsweep.build_batch(tpoints[:1], mode="lifecycle", device="cpu").works is not None
    batch = tsweep.build_batch(tpoints[:1], device="cpu")
    with pytest.raises(ValueError, match="job sizes"):
        tsweep.run_grid(batch, mode="lifecycle")
    with pytest.raises(ValueError, match="job sizes"):
        tsweep.run_grid(batch, ("hesrpt",))
    with pytest.raises(ValueError):
        tsweep.run_grid(batch, mode="stream")
    with pytest.raises(ValueError):
        tsweep.build_batch([], device="cpu")
    faulty = [dataclasses.replace(p, cfg=dataclasses.replace(
        p.cfg, faults=ttrace.FaultConfig(fail_rate=0.1))) for p in tpoints[:1]]
    with pytest.raises(ValueError, match="lifecycle"):
        tsweep.build_batch(faulty, device="cpu")


# ------------------------------------------------------------ lifecycle grid --
LIFECYCLE_ALGORITHMS = ("ogasched", "fairness", "drf", "hesrpt", "multiclass")


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faults"])
def test_lifecycle_grid_equals_looped_run_all(faulted):
    """``run_grid(mode="lifecycle")`` over 3 configs (one ``_step`` over the
    grid a slot) against ``run_all(mode="lifecycle")`` config by config:
    events exactly, rewards and metrics within RTOL (the grid's sums run
    over a batch)."""
    from repro_torch.sched import lifecycle as tl
    from repro_torch.sched import simulator as tsim

    fc = ttrace.FaultConfig(fail_rate=0.05, fail_frac=0.5, repair_mean=10.0) if faulted \
        else ttrace.FaultConfig()
    base = ttrace.TraceConfig(T=40, L=6, R=16, K=4, work_mean=40.0, faults=fc)
    points = tsweep.make_grid(base, seeds=(0, 1, 2), eta0s=(25.0,))
    batch = tsweep.build_batch(points, mode="lifecycle", device="cpu")
    assert (batch.faults is not None) == faulted
    traces = tsweep.run_grid(batch, LIFECYCLE_ALGORITHMS, mode="lifecycle")
    summary = tsweep.summarize_lifecycle(traces, batch)
    for g, p in enumerate(points):
        single = tsim.run_all(p.cfg, algorithms=LIFECYCLE_ALGORITHMS, mode="lifecycle",
                              device="cpu")
        for name in LIFECYCLE_ALGORITHMS:
            tr = traces[name][g]
            np.testing.assert_allclose(tr.rewards.numpy(), single[name].rewards, rtol=RTOL,
                                       atol=RTOL * float(np.abs(single[name].rewards).max()))
            for key, want in single[name].lifecycle.items():
                np.testing.assert_allclose(summary[f"{key}/{name}"][g], want, rtol=RTOL,
                                           atol=RTOL, err_msg=f"{key}/{name}")
        ref = tl.run(batch.spec[g], batch.arrivals[g], batch.works[g], "ogasched",
                     faults=None if batch.faults is None else batch.faults[g], device="cpu")
        for f in ("admitted", "departed", "evicted", "q_depth"):
            assert torch.equal(getattr(traces["ogasched"][g], f), getattr(ref, f)), f
