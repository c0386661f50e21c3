"""The port's streamed Theorem-1 harness (``repro_torch.core.regret``) case
by case against ``tests/test_regret.py``, on the CPU, and against the
reference.

Tolerances:
  * ``offline_optimum_batch``: each row bit for bit ``offline_optimum`` of
    its config (one projection over all rows an iteration, the same
    arithmetic per row), and within atol 1e-4 of the reference's
    ``offline_optimum`` of that config (as tests/test_torch_ogasched.py);
  * streamed curves against resident curves within the port: bit for bit;
  * the port's ``regret_stream`` against the reference's: rtol 1e-4 with
    atol 1e-4 x the grid's largest |R_t| (a curve crosses 0, where only an
    absolute bar means anything); ``h_g`` and the bound rtol 1e-6; eq. 50's
    eta0 rtol 1e-6 (float32 sums in another order);
  * ``sample_ts``, ``fit_growth_exponent``, ``bootstrap_exponent`` and the
    grouping of ``regret_validation`` (``validation_records``) are numpy
    only: bit for bit the reference's on the same curves;
  * at benchmarks/bench_regret.py's quick configuration, the cells of two
    utilities against chip_smoke.py's pinned reference readings with
    chip_smoke.py's own bars (REGRET_R_T_BAR x the bound on r_T_mean,
    REGRET_EXPONENT_ATOL, REGRET_BOUND_RTOL) and equal flags. The largest
    error the port reaches there on the CPU sets those bars (PERF.md).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import chip_smoke
from repro.core import regret as jregret
from repro.sched import sweep as jsweep
from repro.sched import trace as jtrace
from repro_torch.core import ogasched, regret
from repro_torch.sched import sweep, trace

CPU = "cpu"


def _grids(base, **kw):
    tp, tl = regret.make_regret_grid(trace.TraceConfig(**base), device=CPU, **kw)
    jp, jl = jregret.make_regret_grid(jtrace.TraceConfig(**base), **kw)
    return tp, tl, jp, jl


# ----------------------------------------------------- grid + curve engine --
def test_make_regret_grid_matches_reference():
    base = dict(T=300, L=6, R=16, K=4, seed=3)
    tp, tl, jp, jl = _grids(base, utilities=("poly", "linear"),
                            regimes=("stationary", "flash"), seeds=(0, 5))
    assert len(tp) == len(tl) == 8
    assert tl == [regret.RegretLabel(l.utility, l.regime, l.seed) for l in jl]
    assert [(l.utility, l.regime, l.seed) for l in tl[:3]] == [
        ("poly", "stationary", 0), ("poly", "stationary", 5), ("poly", "flash", 0)]
    for p, q, l in zip(tp, jp, tl):
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(q.cfg)
        assert p.decay == q.decay == 1.0
        assert p.eta0 == pytest.approx(q.eta0, rel=1e-6)
        ov = regret.ARRIVAL_REGIMES[l.regime]
        assert (p.cfg.diurnal, p.cfg.burst_prob) == (ov["diurnal"], ov["burst_prob"])
    assert regret.ARRIVAL_REGIMES == jregret.ARRIVAL_REGIMES
    want = float(ogasched.eta_theoretical(trace.build_spec(tp[0].cfg, CPU), 300))
    assert tp[0].eta0 == want
    pinned, _ = regret.make_regret_grid(trace.TraceConfig(**base), utilities=("log",),
                                        seeds=(0,), eta0=2.5, device=CPU)
    assert {p.eta0 for p in pinned} == {2.5}
    with pytest.raises(ValueError, match="unknown regime"):
        regret.make_regret_grid(trace.TraceConfig(**base), regimes=("weekly",), device=CPU)


def test_offline_optimum_batch_rows_equal_single_configs():
    """Rows of a three-config grid are bit for bit each config run alone (a
    one-config grid), and within test_torch_ogasched.py's atol 1e-4 of the
    reference's ``offline_optimum`` of that config."""
    base = dict(T=80, L=5, R=12, K=3, utility="log")
    points = sweep.make_grid(trace.TraceConfig(**base), seeds=range(3))
    batch = sweep.build_batch(points, device=CPU)
    y = regret.offline_optimum_batch(batch.spec, batch.arrivals, iters=150, device=CPU)
    assert y.shape == (3, 5, 12, 3)
    for g, p in enumerate(points):
        single = regret.offline_optimum(batch.spec[g], batch.arrivals[g], iters=150, device=CPU)
        assert torch.equal(y[g], single), g
        jspec, jarr = jtrace.make(jtrace.TraceConfig(**{**base, "utility": p.cfg.utility,
                                                        "seed": p.cfg.seed}))
        np.testing.assert_array_equal(batch.arrivals[g].numpy(), np.asarray(jarr))
        want = np.asarray(jregret.offline_optimum(jspec, jarr, iters=150))
        np.testing.assert_allclose(y[g].numpy(), want, atol=1e-4, err_msg=str(g))


@pytest.mark.parametrize("backend", ("fused", "reference"))
def test_curves_batch_sublinear_small_T(backend):
    """Both OGA backends: curves end below the Thm. 1 bound and the fitted
    growth exponent (where regret is large enough to fit) is below 1."""
    base = trace.TraceConfig(T=256, L=5, R=12, K=3)
    pts, _ = regret.make_regret_grid(base, utilities=("linear",), regimes=("stationary",),
                                     seeds=(0, 1), device=CPU)
    _, batch = next(iter(sweep.iter_batches(pts, len(pts), device=CPU)))
    curves = regret.regret_curves_batch(batch.spec, batch.arrivals, batch.eta0, batch.decay,
                                        oracle_iters=400, backend=backend, device=CPU)
    assert curves.shape == (2, 256)
    ts = np.arange(1, 257)
    for g in range(2):
        row = curves[g].numpy()
        assert row[-1] <= float(regret.regret_bound(batch.spec[g], 256)), (backend, g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exp = regret.fit_growth_exponent(ts, row, t_min=16)
        assert not np.isfinite(exp) or exp < 1.0, (backend, g, exp)


def test_curves_batch_rows_are_regret_curves():
    """Each row is ``regret_curve`` of its config against its own oracle."""
    pts, _ = regret.make_regret_grid(trace.TraceConfig(T=64, L=4, R=8, K=3),
                                     utilities=("poly",), regimes=("flash",), seeds=(0, 1),
                                     device=CPU)
    batch = sweep.build_batch(pts, device=CPU)
    curves = regret.regret_curves_batch(batch.spec, batch.arrivals, batch.eta0, batch.decay,
                                        oracle_iters=100, device=CPU)
    for g in range(2):
        rewards, _ = ogasched.run(batch.spec[g], batch.arrivals[g], eta0=batch.eta0[g],
                                  decay=batch.decay[g], device=CPU)
        y = regret.offline_optimum(batch.spec[g], batch.arrivals[g], iters=100, device=CPU)
        want = regret.regret_curve(batch.spec[g], batch.arrivals[g], rewards, y)
        np.testing.assert_allclose(curves[g].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


def test_regret_stream_matches_batch():
    """Chunked streaming (chunk 2 over 5 points) is a pure reorganisation: its
    sampled curves equal the resident engine's bit for bit."""
    pts, _ = regret.make_regret_grid(trace.TraceConfig(T=128, L=5, R=12, K=3),
                                     utilities=("poly",), regimes=("stationary",),
                                     seeds=(0, 1, 2, 3, 4), device=CPU)
    ts = regret.sample_ts(128, num=16)
    res = regret.regret_stream(pts, ts=ts, chunk_size=2, oracle_iters=300, device=CPU)
    assert res["curves"].shape == (5, len(ts))
    batch = sweep.build_batch(pts, device=CPU)
    full = regret.regret_curves_batch(batch.spec, batch.arrivals, batch.eta0, batch.decay,
                                      oracle_iters=300, device=CPU)
    np.testing.assert_array_equal(res["curves"], full[:, torch.as_tensor(ts - 1)].numpy())
    np.testing.assert_array_equal(res["r_T"], res["curves"][:, -1])
    np.testing.assert_allclose(res["bound"], res["h_g"] * np.sqrt(128.0), rtol=1e-6)


def test_regret_stream_matches_reference():
    base = dict(T=128, L=5, R=12, K=3)
    tp, _, jp, _ = _grids(base, utilities=("poly", "log"), regimes=("stationary", "flash"),
                          seeds=(0, 1, 2))
    ts = regret.sample_ts(128, num=16)
    got = regret.regret_stream(tp, ts=ts, chunk_size=5, oracle_iters=300, device=CPU)
    want = jregret.regret_stream(jp, ts=ts, chunk_size=5, oracle_iters=300)
    np.testing.assert_array_equal(got["ts"], want["ts"])
    scale = float(np.abs(want["curves"]).max())
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(got["h_g"], want["h_g"], rtol=1e-6)
    np.testing.assert_allclose(got["bound"], want["bound"], rtol=1e-6)


def test_regret_stream_validates_inputs():
    pts, _ = regret.make_regret_grid(trace.TraceConfig(T=64, L=4, R=8, K=3),
                                     utilities=("poly",), regimes=("stationary",), seeds=(0,),
                                     device=CPU)
    with pytest.raises(ValueError, match="empty"):
        regret.regret_stream([], device=CPU)
    bad = pts + [dataclasses.replace(pts[0], cfg=dataclasses.replace(pts[0].cfg, T=32))]
    with pytest.raises(ValueError, match="share T"):
        regret.regret_stream(bad, device=CPU)
    with pytest.raises(ValueError, match="strictly increasing"):
        regret.regret_stream(pts, ts=np.asarray([1, 128]), device=CPU)


# ------------------------------------------------------ exponent statistics --
@pytest.mark.parametrize("T", [5, 64, 1000, 50_000])
def test_sample_ts_equals_reference(T):
    np.testing.assert_array_equal(regret.sample_ts(T), jregret.sample_ts(T))
    np.testing.assert_array_equal(regret.sample_ts(T, num=16, t_min=2),
                                  jregret.sample_ts(T, num=16, t_min=2))


def _synthetic_curves(seed=0):
    rng = np.random.default_rng(seed)
    ts = regret.sample_ts(10_000)
    base = 5.0 * ts.astype(float) ** 0.5
    return ts, base[None, :] * rng.uniform(0.8, 1.2, size=(8, 1)) + rng.normal(0, 3, (8, len(ts)))


def test_fit_and_bootstrap_equal_reference_bitwise():
    ts, curves = _synthetic_curves()
    for slope in (0.5, 0.9):
        curve = 3.0 * ts.astype(float) ** slope
        assert regret.fit_growth_exponent(ts, curve) == jregret.fit_growth_exponent(ts, curve)
        assert regret.fit_growth_exponent(ts, curve) == pytest.approx(slope, abs=1e-6)
    for row in curves:
        assert regret.fit_growth_exponent(ts, row, t_min=16) == \
            jregret.fit_growth_exponent(ts, row, t_min=16)
    got = regret.bootstrap_exponent(ts, curves, n_boot=100, seed=3)
    assert got == jregret.bootstrap_exponent(ts, curves, n_boot=100, seed=3)
    assert got["ci_lo"] <= got["exponent"] <= got["ci_hi"] < 1.0
    with pytest.raises(ValueError, match="seeds"):
        regret.bootstrap_exponent(ts, curves[0])


def test_fit_growth_exponent_warns_and_nans_on_unfittable():
    ts = regret.sample_ts(1000)
    with pytest.warns(UserWarning, match="usable curve points"):
        got = regret.fit_growth_exponent(ts, -5.0 * np.ones_like(ts, float))
    assert np.isnan(got)


def test_validation_records_equal_reference_grouping():
    """On the reference's own streamed curves, the port's per-cell records
    equal ``regret_validation``'s bit for bit."""
    base = dict(T=96, L=4, R=8, K=3)
    _, tl, jp, jl = _grids(base, utilities=("linear", "poly"), regimes=("stationary", "flash"),
                           seeds=(0, 1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = jregret.regret_stream(jp, chunk_size=6, oracle_iters=200)
        want = jregret.regret_validation(jp, jl, chunk_size=6, oracle_iters=200, n_boot=30)
        got = regret.validation_records(res, tl, n_boot=30)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], float) and np.isnan(w[k]):
                assert np.isnan(g[k]), k
            else:
                assert g[k] == w[k], k


def test_regret_validation_groups_cells():
    pts, labs = regret.make_regret_grid(trace.TraceConfig(T=96, L=4, R=8, K=3),
                                        utilities=("linear", "poly"), regimes=("stationary",),
                                        seeds=(0, 1), device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        recs = regret.regret_validation(pts, labs, chunk_size=4, oracle_iters=300, n_boot=20,
                                        device=CPU)
    assert {(r["utility"], r["regime"]) for r in recs} == {("linear", "stationary"),
                                                          ("poly", "stationary")}
    for r in recs:
        assert r["n_seeds"] == 2 and r["bound"] > 0.0
        assert isinstance(r["bound_ok"], bool) and isinstance(r["sublinear"], bool)
    with pytest.raises(ValueError, match="parallel"):
        regret.regret_validation(pts, labs[:-1], device=CPU)


# ------------------------------------- bench_regret's quick cells, pinned --
def test_quick_cells_hold_chip_smoke_pins_on_the_cpu():
    """chip_smoke.py's ``regret_validation`` phase, for two of its seven
    utilities (log/flash is the cell furthest from the pins on the CPU),
    run through the port on the CPU: every reading within chip_smoke.py's
    bars of the JAX reference's pinned reading, every flag equal."""
    cfg = chip_smoke.REGRET_CFG
    pts, labs = regret.make_regret_grid(trace.TraceConfig(**cfg), utilities=("log", "reciprocal"),
                                        regimes=chip_smoke.REGRET_REGIMES,
                                        seeds=chip_smoke.REGRET_SEEDS, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        recs = regret.regret_validation(pts, labs, chunk_size=chip_smoke.REGRET_CHUNK,
                                        oracle_iters=chip_smoke.REGRET_ORACLE_ITERS,
                                        n_boot=chip_smoke.REGRET_N_BOOT, device=CPU)
    assert len(recs) == 4
    for r in recs:
        errs = chip_smoke.regret_errors(r, chip_smoke.REGRET_REFERENCE[
            f"{r['utility']}/{r['regime']}"])
        assert errs["flags_equal"], r
        assert errs["r_T_mean"] <= chip_smoke.REGRET_R_T_BAR, (r, errs)
        assert errs["exponent"] <= chip_smoke.REGRET_EXPONENT_ATOL, (r, errs)
        assert errs["bound"] <= chip_smoke.REGRET_BOUND_RTOL, (r, errs)
        assert r["bound_ok"]
