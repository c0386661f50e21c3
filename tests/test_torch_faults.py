"""The port's fault-injected lifecycle against the JAX reference, on the
CPU: the fault streams bit for bit, and the eviction, backoff, retry-budget
and restart-from-zero setups of tests/test_lifecycle_faults.py held to the
reference's readings (T 80, L 6, R 16, K 4, work_mean 40).

Tolerances: ``build_faults`` bitwise (both packages draw the same numpy
streams); discrete events exactly; rewards, JCT, occupancy, drained and
wasted work within rtol 1e-4 (float32 projections in another order).
Where the reference holds a property of its own readings (evictions only
after the outage, conservation of jobs, the JCT anchor), the port's
readings are held to it too. The reference's all-ones-equals-fault-free
check fails on this jax (ROADMAP Queue 3, item 3), so its twin holds the
port's all-ones run to the reference's all-ones run instead.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.sched import lifecycle as jl
from repro.sched import trace as jt
from repro_torch.sched import lifecycle as tl
from repro_torch.sched import trace as tt

from test_torch_lifecycle import assert_summary_matches, assert_trace_matches

KW = dict(T=80, L=6, R=16, K=4, seed=0, work_mean=40.0)
T, L, K = KW["T"], KW["L"], KW["K"]

FAMILIES = {
    "none": {},
    "failures": dict(fail_rate=0.02, fail_frac=0.3, repair_mean=40.0),
    "drains": dict(drain_period=20, drain_len=6, drain_frac=0.5),
    "shocks": dict(shock_rate=0.05, shock_depth=0.5),
    "heavy": dict(fail_rate=0.05, fail_frac=0.5, repair_mean=30.0, shock_rate=0.02,
                  shock_depth=0.3),
    "all": dict(fail_rate=0.03, fail_frac=0.25, repair_mean=10.0, drain_period=30,
                drain_len=5, drain_frac=0.4, shock_rate=0.03, shock_len=4, shock_depth=0.7),
}


@pytest.fixture(scope="module")
def traces():
    jspec, jarr, jworks = jt.make_lifecycle(jt.TraceConfig(**KW))
    tspec, tarr, tworks = tt.make_lifecycle(tt.TraceConfig(**KW), device="cpu")
    return (jspec, jarr, jworks), (tspec, tarr, tworks), tl.default_y0(tspec)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 7])
def test_build_faults_bitwise(family, seed):
    kw = dict(KW, seed=seed, T=300)
    want = np.asarray(jt.build_faults(jt.TraceConfig(**kw, faults=jt.FaultConfig(**FAMILIES[family]))))
    got = tt.build_faults(tt.TraceConfig(**kw, faults=tt.FaultConfig(**FAMILIES[family])),
                          device="cpu")
    assert got.dtype == torch.float32 and got.shape == (300, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tt.FaultConfig(**FAMILIES[family]).active == (family != "none")
    if family != "none":
        assert (want < 1.0).any()


def test_make_batch_stacks_fault_streams():
    cfgs = [dict(KW, seed=s, faults=f) for s, f in ((0, {}), (3, FAMILIES["heavy"]))]
    _, _, jworks, jfaults = jt.make_batch(
        [jt.TraceConfig(**dict(c, faults=jt.FaultConfig(**c["faults"]))) for c in cfgs],
        with_works=True, with_faults=True)
    _, _, tworks, tfaults = tt.make_batch(
        [tt.TraceConfig(**dict(c, faults=tt.FaultConfig(**c["faults"]))) for c in cfgs],
        with_works=True, with_faults=True, device="cpu")
    np.testing.assert_array_equal(tfaults.numpy(), np.asarray(jfaults))
    np.testing.assert_array_equal(tworks.numpy(), np.asarray(jworks))
    assert (tfaults[0] == 1.0).all()


def _outage(t0, t1, depth=0.0):
    f = np.ones((T, K), np.float32)
    f[t0:t1] = depth
    return f


def _one_job(t_arr, port, work, T_=T):
    arr = np.zeros((T_, L), np.float32)
    works = np.full((T_, L), work, np.float32)
    arr[t_arr, port] = 1.0
    return arr, works


def _both(traces, name, f, arr=None, works=None, **kw):
    """(reference trace, port trace) of one setup; ``kw`` may hold
    ``fault_policy`` (a dict of FaultPolicy fields) and ``rate_floor``."""
    (jspec, jarr, jworks), (tspec, tarr, tworks), y0 = traces
    policy = kw.pop("fault_policy", {})
    ja = jarr if arr is None else jnp.asarray(arr)
    jw = jworks if works is None else jnp.asarray(works)
    ta = tarr if arr is None else torch.from_numpy(arr)
    tw = tworks if works is None else torch.from_numpy(works)
    y = y0 if name == "ogasched" else None
    jtr = jl.run(jspec, ja, jw, name, faults=None if f is None else jnp.asarray(f),
                 y0=None if y is None else jnp.asarray(y.numpy()),
                 fault_policy=jl.FaultPolicy(**policy), **kw)
    ttr = tl.run(tspec, ta, tw, name, faults=None if f is None else torch.from_numpy(f),
                 y0=y, fault_policy=tl.FaultPolicy(**policy), device="cpu", **kw)
    assert_trace_matches(ttr, jtr)
    return jtr, ttr


def _counts(tr, arr):
    return dict(
        accepted=float((np.asarray(arr) > 0).sum() - int(tr.dropped[-1])),
        completed=float(tr.departed.sum()), running=float(tr.running[-1].sum()),
        queued=float(tr.q_depth[-1].sum()), rdropped=float(tr.rdropped[-1]),
        evictions=float(tr.evicted.sum()),
    )


@pytest.mark.parametrize("name", ("ogasched", "fairness", "binpacking"))
def test_capacity_collapse_evicts_and_books_balance(traces, name):
    _, ttr = _both(traces, name, _outage(21, 27))
    c = _counts(ttr, traces[1][1])
    assert c["evictions"] > 0
    assert c["accepted"] == c["completed"] + c["running"] + c["queued"] + c["rdropped"]
    assert not bool(ttr.evicted[:21].any())


def test_hesrpt_is_malleable_and_never_evicts(traces):
    _, ttr = _both(traces, "hesrpt", _outage(30, 40, 0.5))
    assert int(ttr.evicted.sum()) == 0 and float(ttr.wasted.sum()) == 0.0
    assert int(ttr.rdropped[-1]) == 0


@pytest.mark.parametrize("name", ("ogasched", "drf"))
def test_conservation_under_heavy_stochastic_faults(traces, name):
    f = tt.build_faults(tt.TraceConfig(**KW, faults=tt.FaultConfig(**FAMILIES["heavy"])),
                        device="cpu").numpy()
    _, ttr = _both(traces, name, f)
    c = _counts(ttr, traces[1][1])
    assert c["accepted"] == c["completed"] + c["running"] + c["queued"] + c["rdropped"]


def test_requeued_job_keeps_its_arrival_anchor(traces):
    arr, works = _one_job(0, 0, 500.0)
    _, ttr = _both(traces, "fairness", _outage(3, 5), arr, works)
    assert bool(ttr.evicted[3, 0])
    adm = ttr.admitted[:, 0].numpy()
    assert adm[0] and adm[5] and adm.sum() == 2
    t_dep = int(np.nonzero(ttr.departed[:, 0].numpy())[0][0])
    jct, svc = float(ttr.jct[t_dep, 0]), float(ttr.svc_slots[t_dep, 0])
    assert jct == t_dep + 1 and svc == t_dep - 5 + 1 and jct - svc == 5


def test_zero_capacity_window_no_deadlock_no_nan(traces):
    _, ttr = _both(traces, "ogasched", _outage(10, 20))
    for f in tl.LifecycleTrace.FIELDS:
        assert torch.isfinite(getattr(ttr, f).float()).all(), f
    arr = np.zeros((T, L), np.float32)
    arr[5, :] = 1.0
    works = np.full((T, L), 2.5e-3, np.float32)  # ~3 slots at the rate floor
    _, dead = _both(traces, "ogasched", np.zeros((T, K), np.float32), arr, works,
                    rate_floor=1e-3)
    assert int(dead.departed.sum()) == L


def test_arrival_into_outage_is_admitted_not_evicted(traces):
    arr = np.zeros((T, L), np.float32)
    works = np.full((T, L), 2000.0, np.float32)
    arr[2, 0] = 1.0
    arr[10, 1] = 1.0
    _, ttr = _both(traces, "fairness", _outage(10, 14), arr, works)
    assert bool(ttr.admitted[10, 1]) and not bool(ttr.evicted[10, 1])
    assert bool(ttr.evicted[10, 0])


def test_retry_budget_exhaustion_drops_and_conserves(traces):
    arr, works = _one_job(0, 0, 1e6)
    _, ttr = _both(traces, "fairness", _outage(5, 8), arr, works,
                   fault_policy=dict(max_retries=0))
    assert int(ttr.evicted.sum()) == 1 and int(ttr.rdropped[-1]) == 1
    assert float(ttr.wasted.sum()) > 0
    assert int(ttr.running[-1].sum()) == 0 and int(ttr.q_depth[-1].sum()) == 0
    assert int(ttr.departed.sum()) == 0


def test_backoff_gates_readmission(traces):
    arr, works = _one_job(0, 0, 1e6)
    _, ttr = _both(traces, "fairness", _outage(5, 6), arr, works,
                   fault_policy=dict(backoff_base=8.0, max_retries=3))
    adm = ttr.admitted[:, 0].numpy()
    assert bool(ttr.evicted[5, 0]) and not adm[6:13].any() and adm[13:].any()


def test_backoff_is_capped_and_exponential(traces):
    """Outages every few slots: retry n waits min(base 2^(n-1), cap), the
    queue's ready slots equal the reference's."""
    arr, works = _one_job(0, 0, 1e6)
    f = np.ones((T, K), np.float32)
    for t0 in (4, 9, 16, 29, 50):
        f[t0] = 0.0
    _, ttr = _both(traces, "fairness", f, arr, works,
                   fault_policy=dict(backoff_base=2.0, backoff_cap=8.0, max_retries=6))
    assert int(ttr.evicted.sum()) >= 3


def test_restart_from_zero_wastes_what_preserve_work_keeps(traces):
    (_, _, _), (tspec, _, _), _ = traces
    arr, works = _one_job(0, 0, 5000.0)
    _, keep = _both(traces, "fairness", _outage(10, 12), arr, works,
                    fault_policy=dict(preserve_work=True))
    _, restart = _both(traces, "fairness", _outage(10, 12), arr, works,
                       fault_policy=dict(preserve_work=False))
    assert int(keep.evicted.sum()) == 1 == int(restart.evicted.sum())
    assert float(keep.wasted.sum()) == 0.0
    done_pre = float(keep.work_done[:10, 0].sum())
    assert float(restart.wasted.sum()) == pytest.approx(done_pre, rel=1e-4)
    assert tl.summarize(restart, tspec)["goodput"] < tl.summarize(keep, tspec)["goodput"]


@pytest.mark.parametrize("name", tl.ALGORITHMS + ("hesrpt",))
def test_all_ones_faults_match_the_references_all_ones_run(traces, name):
    """An all-ones stream takes the fault path (evictions checked, backoff
    gates read) with nothing to evict: the port's readings against the
    reference's on the same stream."""
    _, ttr = _both(traces, name, np.ones((T, K), np.float32))
    assert int(ttr.evicted.sum()) == 0 and float(ttr.wasted.sum()) == 0.0


def test_summarize_reports_robustness_metrics(traces):
    (jspec, _, _), (tspec, _, _), _ = traces
    jtr, ttr = _both(traces, "ogasched", _outage(21, 27, 0.2))
    s = tl.summarize(ttr, tspec)
    assert_summary_matches(s, jl.summarize(jtr, jspec))
    for key in ("goodput", "wasted_work", "evictions", "fault_drops"):
        assert np.isfinite(s[key])
    assert s["evictions"] > 0


def test_fault_policy_is_frozen_and_hashable():
    p = tl.FaultPolicy(max_retries=1)
    assert hash(p) == hash(tl.FaultPolicy(max_retries=1)) and p != tl.FaultPolicy()
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.max_retries = 2
    assert dataclasses.asdict(tl.FaultPolicy()) == dataclasses.asdict(jl.FaultPolicy())
