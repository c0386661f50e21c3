"""The port's job lifecycle (``repro_torch.sched.lifecycle``) against the
JAX reference's, on the CPU, at T 64, L 6, R 16, K 4.

Both packages read the same numpy traces and start OGASCHED from the same
y0 (the port's default, a numpy draw; the reference would draw its own
from a JAX key). Tolerances: discrete events (admissions, departures,
evictions, queue contents, counters) exactly; per-slot rewards, JCT,
occupancy and drained work, and every ``summarize`` metric, within
rtol 1e-4 (both project in float32, in another order: the readings sit
~2e-7 apart); one slot stepped from a carried-over mid-trace state within
rtol 1e-5 on every float field of the state and the events.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core import baselines as jbase
from repro.core import graph as jgraph
from repro.kernels import ops as jops
from repro.sched import lifecycle as jl
from repro.sched import trace as jt
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import graph as tgraph
from repro_torch.core import ogasched as tog
from repro_torch.core.graph import ClusterSpec
from repro_torch.kernels import ops as tops
from repro_torch.sched import lifecycle as tl
from repro_torch.sched import simulator as tsim
from repro_torch.sched import trace as tt

KW = dict(T=64, L=6, R=16, K=4, seed=1, work_mean=40.0)
RTOL = 1e-4
STEP_RTOL = 1e-5
DISCRETE = ("admitted", "departed", "running", "q_depth", "dropped", "evicted", "rdropped")
CONTINUOUS = ("rewards", "jct", "svc_slots", "used", "wasted", "work_done")


@pytest.fixture(scope="module")
def traces():
    jspec, jarr, jworks = jt.make_lifecycle(jt.TraceConfig(**KW))
    tspec, tarr, tworks = tt.make_lifecycle(tt.TraceConfig(**KW), device="cpu")
    y0 = tl.default_y0(tspec)
    return (jspec, jarr, jworks), (tspec, tarr, tworks), y0


def _outage(T, K, t0, t1, depth=0.0):
    f = np.ones((T, K), np.float32)
    f[t0:t1] = depth
    return f


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def assert_trace_matches(ttr, jtr, rtol=RTOL):
    """The port's trace against the reference's: events exactly, the rest
    within ``rtol``."""
    for f in DISCRETE:
        np.testing.assert_array_equal(getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f)),
                                      err_msg=f)
    for f in CONTINUOUS:
        _close(getattr(ttr, f).numpy(), getattr(jtr, f), rtol, f)


def assert_summary_matches(got: dict, want: dict, rtol=RTOL):
    assert set(got) == set(want)
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=rtol, err_msg=k)


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("name", tl.ALL_ALGORITHMS)
def test_run_matches_reference(traces, name, faulted):
    (jspec, jarr, jworks), (tspec, tarr, tworks), y0 = traces
    f = _outage(KW["T"], KW["K"], 21, 27, 0.2) if faulted else None
    jtr = jl.run(jspec, jarr, jworks, name, y0=jnp.asarray(y0.numpy()),
                 faults=None if f is None else jnp.asarray(f))
    ttr = tl.run(tspec, tarr, tworks, name, y0=y0,
                 faults=None if f is None else torch.from_numpy(f), device="cpu")
    assert ttr.rewards.shape == (KW["T"],)
    assert_trace_matches(ttr, jtr)
    assert_summary_matches(tl.summarize(ttr, tspec), jl.summarize(jtr, jspec))


def test_reference_backend_matches_reference(traces):
    (jspec, jarr, jworks), (tspec, tarr, tworks), y0 = traces
    jtr = jl.run(jspec, jarr, jworks, "ogasched", backend="reference",
                 y0=jnp.asarray(y0.numpy()))
    ttr = tl.run(tspec, tarr, tworks, "ogasched", backend="reference", y0=y0, device="cpu")
    assert_trace_matches(ttr, jtr)


# --------------------------------------------- one slot from a carried state --
def _reference_state(jspec, jarr, jworks, jf, name, t0, y0, policy):
    """The reference's lifecycle state after t0 slots, by its own ``_step``
    under ``lax.scan`` with ``run``'s arguments, and its one-slot step."""
    use_oga = name == "ogasched"
    operands = jops.pack_spec_operands(jspec) if use_oga else None
    step_w = None if use_oga else jbase.default_parallelism(jspec, name)

    def body(s, xs):
        return jl._step(jspec, s, xs[0], xs[1], xs[2], algorithm=name, decay=0.9999,
                        rate_floor=1e-3, backend="fused", step_w=step_w,
                        operands=operands, fault_policy=policy)

    state = jl.init_state(jspec, 25.0, 8, jnp.asarray(y0) if use_oga else None)
    state, _ = jax.jit(lambda s, xs: jax.lax.scan(body, s, xs))(
        state, (jarr[:t0], jworks[:t0], jf[:t0]))
    after, events = jax.jit(body)(state, (jarr[t0], jworks[t0], jf[t0]))
    return state, after, events


@pytest.mark.parametrize("name", tl.ALL_ALGORITHMS)
def test_one_slot_from_a_carried_state(traces, name):
    """Both packages step the same mid-trace state (converted with
    ``convert.lifecycle_state_from_reference``) through the first slot of
    an outage: the discrete events (evictions, re-queues, admissions,
    departures, queue contents, counters) equal, the float fields within
    STEP_RTOL. No trajectory drift can enter: the state is the
    reference's own."""
    (jspec, jarr, jworks), (tspec, tarr, tworks), y0 = traces
    t0 = 30
    f = _outage(KW["T"], KW["K"], t0, t0 + 4, 0.3)
    policy = jl.FaultPolicy(max_retries=2)
    jstate, jafter, jevents = _reference_state(jspec, jarr, jworks, jnp.asarray(f), name, t0,
                                               y0.numpy(), policy)
    state = convert.lifecycle_state_from_reference(jstate, "cpu")
    assert state.t == t0 and bool((state.remaining > 0).any())
    spec = ClusterSpec.stack([tspec])
    use_oga = name == "ogasched"
    after, events = tl._step(
        spec, state, tarr[None, t0], tworks[None, t0], torch.from_numpy(f[None, t0]),
        algorithm=name, decay=torch.tensor(0.9999), rate_floor=1e-3, backend="fused",
        step_w=None if use_oga else tbase.default_parallelism(spec, name),
        operands=tops.pack_spec_operands(spec),
        fault_policy=tl.FaultPolicy(max_retries=2))
    for f_name in tl.LifecycleState.__dataclass_fields__:
        got, want = getattr(after, f_name), np.asarray(getattr(jafter, f_name))
        if f_name == "t":
            assert got == int(want) == t0 + 1
        elif want.dtype.kind in "iub":
            np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f_name)
        else:
            _close(got[0].numpy(), want, STEP_RTOL, f_name)
    for f_name, got, want in zip(tl.LifecycleTrace.FIELDS, events, jevents):
        want = np.asarray(want)
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f_name)
        else:
            _close(got[0].numpy(), want, STEP_RTOL, f_name)
    if name not in tbase.SIZE_AWARE:
        assert bool(events[tl.LifecycleTrace.FIELDS.index("evicted")].any())


def test_state_conversion_round_trips(traces):
    (jspec, _, _), (tspec, _, _), y0 = traces
    got = convert.lifecycle_state_from_reference(
        jl.init_state(jspec, 25.0, 8, jnp.asarray(y0.numpy())), "cpu")
    want = tl.init_state(tspec, 25.0, 8, y0)
    for f in tl.LifecycleState.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if f == "t":
            assert a == b == 0
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f


# ------------------------------------------------------------- summaries --
def test_summarize_batch_matches_reference_and_per_row(traces):
    """``summarize_batch`` over a 2-config grid against the reference's on
    the same traces, and against ``summarize`` row by row."""
    (jspec, jarr, jworks), (tspec, tarr, tworks), y0 = traces
    jtrs = [jl.run(jspec, jarr, jworks, n, y0=jnp.asarray(y0.numpy())) for n in ("fairness", "drf")]
    jb = jax.tree.map(lambda *ls: jnp.stack(ls), *jtrs)
    jspec2 = jax.tree.map(lambda *ls: jnp.stack(ls), jspec, jspec)
    want = jl.summarize_batch(jb, jspec2)
    ttrs = [tl.run(tspec, tarr, tworks, n, device="cpu") for n in ("fairness", "drf")]
    tb = tl.LifecycleTrace(*(torch.stack([getattr(t, f) for t in ttrs])
                             for f in tl.LifecycleTrace.FIELDS))
    got = tl.summarize_batch(tb, ClusterSpec.stack([tspec, tspec]))
    assert set(got) == set(want)  # a jitted dict comes back with its keys sorted
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=RTOL,
                                   err_msg=k)
        for g, ttr in enumerate(ttrs):
            # float32 means on the device against float64 ones on the host
            np.testing.assert_allclose(float(got[k][g]), tl.summarize(ttr, tspec)[k],
                                       rtol=1e-5, err_msg=k)


def test_summarize_batch_nan_without_departures(traces):
    (_, _, _), (tspec, tarr, tworks), _ = traces
    tr = tl.run(tspec, torch.zeros_like(tarr), tworks, "fairness", device="cpu")
    s = tl.summarize(tr, tspec)
    b = tl.summarize_batch(tl.LifecycleTrace(
        *(getattr(tr, f)[None] for f in tl.LifecycleTrace.FIELDS)), ClusterSpec.stack([tspec]))
    for k in ("jct_mean", "jct_p99", "slowdown_mean"):
        assert np.isnan(s[k]) and torch.isnan(b[k]).all()
    assert s["completed"] == 0.0 == float(b["completed"][0])


@pytest.mark.parametrize("case", ["never", "recovers", "never_recovers", "fault_at_0",
                                  "stochastic"])
def test_recovery_time_matches_reference(case):
    T = 400
    f = np.ones((T, 2), np.float32)
    r = np.ones(T)
    if case == "recovers":
        f[100:120] = 0.0
        r[100:150] = 0.0
    elif case == "never_recovers":
        f[100:120] = 0.0
        r[100:] = 0.0
    elif case == "fault_at_0":
        f[:] = 0.0
    elif case == "stochastic":
        rng = np.random.default_rng(3)
        f[150:190] = 0.5
        r = rng.uniform(0.5, 1.5, T)
        r[150:230] *= 0.3
    for window in (10, 25):
        want = jl.recovery_time(r, f, window=window)
        got = tl.recovery_time(r, f, window=window)
        assert (np.isnan(got) and np.isnan(want)) or got == want, (case, got, want)


# --------------------------------------------------- graph and validation --
def test_residual_capacity_matches_reference(traces):
    (jspec, _, _), (tspec, _, _), y0 = traces
    rng = np.random.default_rng(5)
    held = (rng.uniform(0.0, 30.0, (KW["L"], KW["R"], KW["K"]))).astype(np.float32)
    cap = (np.asarray(jspec.c) * rng.uniform(0.2, 1.0, KW["K"])).astype(np.float32)
    for capacity in (None, cap):
        want = jgraph.residual_capacity(jspec, jnp.asarray(held),
                                        None if capacity is None else jnp.asarray(capacity))
        got = tgraph.residual_capacity(tspec, torch.from_numpy(held),
                                       None if capacity is None else torch.from_numpy(capacity))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
        assert (got >= 0).all()
        res = tgraph.residual_spec(tspec, torch.from_numpy(held),
                                   None if capacity is None else torch.from_numpy(capacity))
        assert torch.equal(res.c, got) and torch.equal(res.a, tspec.a)
    same = tgraph.residual_spec(tspec, torch.zeros(KW["L"], KW["R"], KW["K"]))
    assert torch.equal(same.c, tspec.c)


def test_random_feasible_decision_is_feasible(traces):
    (_, _, _), (tspec, _, _), y0 = traces
    assert bool(tgraph.feasible(tspec, y0, tol=1e-5))
    again = tgraph.random_feasible_decision(tspec, np.random.default_rng(0))
    assert torch.equal(again, y0)
    gen = torch.Generator().manual_seed(0)
    assert bool(tgraph.feasible(tspec, tgraph.random_feasible_decision(tspec, gen), tol=1e-5))
    spec = tgraph.make_random_spec(torch.Generator().manual_seed(1), L=6, R=16, K=4)
    assert (spec.mask.sum(1) >= 1).all() and (spec.c >= 20).all() and (spec.c <= 100).all()


def test_run_rejects_bad_works_and_faults_shapes(traces):
    (_, _, _), (tspec, tarr, tworks), _ = traces
    with pytest.raises(ValueError, match="works"):
        tl.run(tspec, tarr, tworks[:-1], "fairness", device="cpu")
    with pytest.raises(ValueError, match=r"\(T, K\)"):
        tl.run(tspec, tarr, tworks, "fairness",
               faults=torch.ones(KW["T"], KW["K"] + 1), device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        tl.run(tspec, tarr, tworks, "quickselect", device="cpu")


# ------------------------------------------------------ duration-1 reduction --
@pytest.mark.parametrize("name", ("ogasched",) + tbase.BASELINES)
def test_duration1_reduces_to_slot_mode(traces, name):
    """Every job's work ~0: nothing queues or overlaps, the residual is the
    full capacity, and the lifecycle's per-slot rewards equal slot mode's
    (the reference's bar, tests/test_lifecycle.py: 1e-4 of the largest)."""
    (_, _, _), (tspec, tarr, _), y0 = traces
    works = torch.zeros_like(tarr)
    if name == "ogasched":
        r_slot, _ = tog.run(tspec, tarr, eta0=10.0, decay=0.999, y0=y0, device="cpu")
        tr = tl.run(tspec, tarr, works, name, eta0=10.0, decay=0.999, y0=y0, device="cpu")
    else:
        r_slot = tbase.run(tspec, tarr, name, device="cpu")
        tr = tl.run(tspec, tarr, works, name, device="cpu")
    scale = max(1.0, float(r_slot.abs().max()))
    np.testing.assert_allclose(tr.rewards.numpy(), r_slot.numpy(), atol=1e-4 * scale, rtol=0)
    assert int(tr.dropped[-1]) == 0 and not bool(tr.running[-1].any())
    assert (tr.jct[tr.departed] == 1.0).all()


def test_run_all_lifecycle_matches_reference(traces):
    """``simulator.run_all(mode="lifecycle")`` fills ``SimResult.lifecycle``
    with the reference's metrics (heuristics: no y0 enters)."""
    from repro.sched import simulator as jsim

    algs = ("fairness", "hesrpt", "multiclass")
    want = jsim.run_all(jt.TraceConfig(**KW), algorithms=algs, mode="lifecycle")
    got = tsim.run_all(tt.TraceConfig(**KW), algorithms=algs, mode="lifecycle", device="cpu")
    assert list(got) == list(want)
    for n in algs:
        np.testing.assert_allclose(got[n].avg_reward, want[n].avg_reward, rtol=RTOL)
        assert_summary_matches(got[n].lifecycle, want[n].lifecycle)
    faulty = dataclasses.replace(tt.TraceConfig(**KW), faults=tt.FaultConfig(fail_rate=0.05))
    with pytest.raises(ValueError, match="lifecycle"):
        tsim.run_all(faulty, device="cpu")
