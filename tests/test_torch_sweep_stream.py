"""The port's streamed and resumable sweep (``repro_torch.sched.sweep``)
case by case against ``tests/test_sweep_stream.py`` and
``tests/test_sweep_resume.py``, on the CPU, and against the reference:

  * streamed equals resident bit for bit within the port, in slot and
    lifecycle mode, with host and with device traces, on grids that do not
    divide by the chunk size (the padded last chunk must be invisible);
  * the port's ``sweep_stream`` summaries against the reference's: average
    rewards and lifecycle metrics rtol 1e-5 (float32 arithmetic in another
    order, as tests/test_torch_sweep.py holds ``run_grid``), improvement
    percentages atol 1e-3 points. In lifecycle mode the heuristics only:
    OGASCHED starts from ``lifecycle.default_y0`` in the port and from a
    JAX PRNG draw in the reference (tests/test_torch_lifecycle.py passes
    one start to both);
  * ``sweep_fingerprint`` equals the reference's hex digest for the same
    grid and run parameters, and either package resumes the other's store;
  * the prefetcher keeps order, propagates errors, stops when abandoned
    and joins its worker at close; resume computes only missing chunks and
    gives the uninterrupted run's bits.
"""
import dataclasses
import itertools
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.sched import lifecycle as jlifecycle
from repro.sched import sweep as jsweep
from repro.sched import trace as jtrace
from repro_torch.ckpt import checkpoint as C
from repro_torch.sched import lifecycle, sweep, trace

CPU = "cpu"
BASE = dict(T=60, L=6, R=16, K=4)
TBASE = trace.TraceConfig(**BASE)
ALGOS = ("ogasched", "fairness", "drf")
RTOL = 1e-5


def _points(n=5, **kw):
    return sweep.make_grid(TBASE, seeds=range(n), **kw)


def _assert_same_batch(a, b):
    for f in a.spec.FIELDS:
        assert torch.equal(getattr(a.spec, f), getattr(b.spec, f)), f
    assert torch.equal(a.arrivals, b.arrivals)


def _assert_same_summary(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- stream --
def test_iter_batches_pads_and_slices():
    chunks = list(sweep.iter_batches(_points(5), 2, device=CPU))
    assert [(sl.start, sl.stop) for sl, _ in chunks] == [(0, 2), (2, 4), (4, 5)]
    assert all(b.size == 2 for _, b in chunks)  # one kernel shape per chunk
    last = chunks[-1][1]
    assert torch.equal(last.arrivals[0], last.arrivals[1])  # the pad repeats the last row
    assert len(last.points) == 1
    with pytest.raises(ValueError):
        list(sweep.iter_batches(_points(5), 0, device=CPU))
    with pytest.raises(ValueError):
        list(sweep.iter_batches(_points(5), 2, start_chunk=-1, device=CPU))


def test_stream_matches_resident_slot():
    """7 points, chunk 3 (3 + 3 + 1 padded): rewards and summaries equal
    the one-shot grid bit for bit."""
    points = sweep.make_grid(TBASE, eta0s=(10.0, 25.0), seeds=(0, 1, 2, 3))[:7]
    resident = sweep.run_grid(sweep.build_batch(points, device=CPU), ALGOS)
    seen = 0
    for sl, chunk_batch, out in sweep.run_grid_stream(points, ALGOS, chunk_size=3,
                                                      device=CPU):
        g = sl.stop - sl.start
        assert chunk_batch.arrivals.shape[0] == g  # trimmed, not padded
        for name in ALGOS:
            assert torch.equal(out[name], resident[name][sl]), (name, sl)
        seen += g
    assert seen == len(points)
    _assert_same_summary(sweep.sweep_stream(points, ALGOS, chunk_size=3, device=CPU),
                         sweep.summarize(resident))


def test_stream_matches_resident_lifecycle():
    points = _points(5)
    algos = ("ogasched", "fairness")
    batch = sweep.build_batch(points, mode="lifecycle", device=CPU)
    resident = sweep.run_grid(batch, algos, mode="lifecycle")
    for sl, _, out in sweep.run_grid_stream(points, algos, chunk_size=2, mode="lifecycle",
                                            device=CPU):
        for name, tr in out.items():
            for f in lifecycle.LifecycleTrace.FIELDS:
                assert torch.equal(getattr(tr, f), getattr(resident[name], f)[sl]), (name, f)
    _assert_same_summary(
        sweep.sweep_stream(points, algos, chunk_size=2, mode="lifecycle", device=CPU),
        sweep.summarize_lifecycle(resident, batch))


def test_stream_matches_resident_device_traces():
    """With device traces on both sides the stream is still a pure
    reorganisation: chunked generation is per-config."""
    points = _points(5)
    resident = sweep.run_grid(sweep.build_batch(points, trace_backend="device", device=CPU),
                              ("ogasched", "fairness"))
    streamed = sweep.sweep_stream(points, ("ogasched", "fairness"), chunk_size=2,
                                  trace_backend="device", device=CPU)
    _assert_same_summary(streamed, sweep.summarize(resident))


def test_device_lifecycle_stream_runs_and_summarizes():
    out = sweep.sweep_stream(_points(3), ("ogasched", "fairness"), chunk_size=2,
                             mode="lifecycle", trace_backend="device", device=CPU)
    assert out["completed/ogasched"].shape == (3,)
    assert np.isfinite(out["utilization/ogasched"]).all()
    assert (out["completed/ogasched"] > 0).any()


def test_stream_stats_and_donation_on_the_cpu():
    """``stats`` accumulates the consumer's wait; donation is a card-only
    reorganisation, so on the CPU the yielded batch keeps its inputs."""
    stats = {}
    for _, batch, _ in sweep.run_grid_stream(_points(4), ("ogasched",), chunk_size=2,
                                             donate=True, stats=stats, device=CPU):
        assert batch.arrivals is not None
    assert stats["chunk_wait_s"] > 0.0


@pytest.mark.parametrize("mode", ["slot", "lifecycle"])
def test_run_grid_sharded_equals_run_grid(mode):
    """The grid split over several devices (here three CPU devices, so 5
    rows pad to 6) gives run_grid's rows; one device is run_grid."""
    points = _points(5)
    batch = sweep.build_batch(points, mode=mode, device=CPU)
    algos = ("ogasched", "fairness")
    want = sweep.run_grid(batch, algos, mode=mode)
    for mesh in (None, (CPU,), (CPU, CPU, CPU)):
        got = sweep.run_grid_sharded(batch, algos, mode=mode, mesh=mesh)
        for name in algos:
            if mode == "slot":
                assert torch.equal(got[name], want[name])
            else:
                for f in lifecycle.LifecycleTrace.FIELDS:
                    assert torch.equal(getattr(got[name], f), getattr(want[name], f)), f
    with pytest.raises(ValueError, match="job sizes"):
        sweep.run_grid_sharded(sweep.build_batch(points, device=CPU), mode="lifecycle",
                               mesh=(CPU, CPU))


def test_grid_memory_bytes_model_matches_reference():
    jbase = jtrace.TraceConfig(**BASE)
    for kw in (dict(), dict(prefetch=2), dict(mode="lifecycle"),
               dict(mode="lifecycle", prefetch=3, algorithms=("ogasched",))):
        assert sweep.grid_memory_bytes(TBASE, 100, **kw) == \
            jsweep.grid_memory_bytes(jbase, 100, **kw), kw
    faulted = dataclasses.replace(TBASE, faults=trace.FaultConfig(fail_rate=0.1))
    jfaulted = dataclasses.replace(jbase, faults=jtrace.FaultConfig(fail_rate=0.1))
    assert sweep.grid_memory_bytes(faulted, 7, mode="lifecycle") == \
        jsweep.grid_memory_bytes(jfaulted, 7, mode="lifecycle")
    m1, m2 = sweep.grid_memory_bytes(TBASE, 100), sweep.grid_memory_bytes(TBASE, 200)
    assert m2["total"] == 2 * m1["total"]
    assert sweep.grid_memory_bytes(TBASE, 100, mode="lifecycle")["outputs"] > 50 * m1["outputs"]
    m = sweep.grid_memory_bytes(TBASE, 64, prefetch=2)
    assert m["prefetch_buffers"] == 3 * m["inputs"]


def test_resolve_trace_backend_rules():
    assert sweep.resolve_trace_backend("host", 10 ** 6) == "host"
    assert sweep.resolve_trace_backend("device", 1) == "device"
    assert sweep.resolve_trace_backend("auto", 8) == "host"
    assert sweep.resolve_trace_backend("auto", sweep.DEVICE_TRACE_MIN_POINTS) == "device"
    assert sweep.DEVICE_TRACE_MIN_POINTS == jsweep.DEVICE_TRACE_MIN_POINTS
    with pytest.raises(ValueError):
        sweep.resolve_trace_backend("tpu", 8)


# -------------------------------------------------------------- prefetch --
def _prefetch_workers():
    return [t for t in threading.enumerate()
            if t.name == "sweep-chunk-prefetch" and t.is_alive()]


def _wait_no_workers(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _prefetch_workers() and time.monotonic() < deadline:
        time.sleep(0.01)
    return _prefetch_workers()


def test_prefetched_iter_batches_matches_sync():
    points = _points(5)
    sync = list(sweep.iter_batches(points, 2, prefetch=0, device=CPU))
    pre = list(sweep.iter_batches(points, 2, prefetch=2, device=CPU))
    assert [(s.start, s.stop) for s, _ in sync] == [(s.start, s.stop) for s, _ in pre]
    for (_, bs), (_, bp) in zip(sync, pre):
        _assert_same_batch(bs, bp)


def test_prefetch_propagates_worker_errors():
    bad = _points(2) + [sweep.SweepPoint(cfg=dataclasses.replace(TBASE, R=TBASE.R + 1))]
    with pytest.raises(ValueError, match="share"):
        list(sweep.iter_batches(bad, 3, prefetch=2, device=CPU))
    assert _wait_no_workers() == []


def test_prefetch_survives_early_abandonment():
    it = sweep.run_grid_stream(_points(8), ("fairness",), chunk_size=2, device=CPU)
    next(it)
    it.close()  # GeneratorExit must unwind the prefetcher
    assert _wait_no_workers() == []


def test_prefetch_midstream_exception_preserves_order():
    def gen():
        yield "a"
        yield "b"
        raise RuntimeError("boom at item 3")

    it = sweep._prefetched(gen(), depth=2)
    assert next(it) == "a"
    assert next(it) == "b"
    with pytest.raises(RuntimeError, match="boom at item 3"):
        next(it)
    assert _prefetch_workers() == []  # the raise path also joins the worker


def test_prefetch_exception_in_later_chunk_after_good_chunks():
    bad = _points(3) + [sweep.SweepPoint(cfg=dataclasses.replace(TBASE, R=TBASE.R + 1))]
    it = sweep.iter_batches(bad, 2, prefetch=2, device=CPU)
    sl, batch = next(it)
    assert (sl.start, sl.stop) == (0, 2) and batch.size == 2
    with pytest.raises(ValueError, match="share"):
        list(it)
    assert _prefetch_workers() == []


def test_prefetch_close_joins_worker():
    it = sweep._prefetched(itertools.count(), depth=2)
    assert next(it) == 0
    it.close()
    assert _wait_no_workers() == []


# ----------------------------------------------------- against the reference --
def test_sweep_stream_matches_reference_slot():
    tpoints = _points(5, eta0s=(25.0, 5.0))
    jpoints = jsweep.make_grid(jtrace.TraceConfig(**BASE), seeds=range(5), eta0s=(25.0, 5.0))
    got = sweep.sweep_stream(tpoints, ALGOS, chunk_size=4, device=CPU)
    want = jsweep.sweep_stream(jpoints, ALGOS, chunk_size=4)
    assert set(got) == set(want)
    for k in want:
        if k.startswith("avg/"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


def test_sweep_stream_matches_reference_lifecycle_heuristics():
    algos = ("fairness", "drf")
    got = sweep.sweep_stream(_points(3), algos, chunk_size=2, mode="lifecycle", device=CPU)
    want = jsweep.sweep_stream(jsweep.make_grid(jtrace.TraceConfig(**BASE), seeds=range(3)),
                               algos, chunk_size=2, mode="lifecycle")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=RTOL, err_msg=k)


# ----------------------------------------------------------- fingerprints --
def _both_grids(n=4, **axes):
    return (sweep.make_grid(TBASE, seeds=range(n), **axes),
            jsweep.make_grid(jtrace.TraceConfig(**BASE), seeds=range(n), **axes))


@pytest.mark.parametrize("kw", [
    dict(chunk_size=2),
    dict(chunk_size=4, mode="lifecycle", queue_depth=4, rate_floor=1e-2),
    dict(chunk_size=2, trace_backend="device", backend="reference"),
    dict(chunk_size=3, mode="lifecycle", policy=dict(max_retries=1, preserve_work=False, backoff_base=4.0)),
], ids=["slot", "lifecycle", "device-traces", "fault-policy"])
def test_fingerprint_equals_the_reference_digest(kw):
    kw = dict(kw)
    policy = kw.pop("policy", None)
    tkw, jkw = dict(kw), dict(kw)
    if policy is not None:
        tkw["fault_policy"] = lifecycle.FaultPolicy(**policy)
        jkw["fault_policy"] = jlifecycle.FaultPolicy(**policy)
    fc = dict(fail_rate=0.02, drain_period=50)
    tpts, jpts = _both_grids(4, eta0s=(25.0, 7.5))
    tpts = [dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, faults=trace.FaultConfig(**fc)))
            for p in tpts]
    jpts = [dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, faults=jtrace.FaultConfig(**fc)))
            for p in jpts]
    algos = ("ogasched", "fairness")
    assert sweep.sweep_fingerprint(tpts, algos, **tkw) == \
        jsweep.sweep_fingerprint(jpts, algos, **jkw)


def test_fingerprint_binds_grid_and_run_parameters():
    pts = _points(4)
    fp = sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2)
    assert fp == sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2)
    assert fp != sweep.sweep_fingerprint(pts[:3], ALGOS[:2], chunk_size=2)
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=4)
    assert fp != sweep.sweep_fingerprint(pts, ("ogasched",), chunk_size=2)
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2, mode="lifecycle")
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2, backend="reference")
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2, queue_depth=4)
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2, rate_floor=1e-2)
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2,
                                         fault_policy=lifecycle.FaultPolicy(max_retries=1))
    assert fp != sweep.sweep_fingerprint(sweep.make_grid(TBASE, eta0s=(10.0,), seeds=range(4)),
                                         ALGOS[:2], chunk_size=2)
    rho = [dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, rho=0.5)) for p in pts]
    assert fp != sweep.sweep_fingerprint(rho, ALGOS[:2], chunk_size=2)
    # "auto" fingerprints as what it resolves to (host, on a small grid)
    assert fp == sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2, trace_backend="host")
    assert fp != sweep.sweep_fingerprint(pts, ALGOS[:2], chunk_size=2, trace_backend="device")


def test_mismatched_store_refuses_resume(tmp_path):
    d = str(tmp_path)
    sweep.SweepCheckpoint(d, _points(4), ALGOS, chunk_size=2)
    with pytest.raises(sweep.SweepResumeMismatch):
        sweep.SweepCheckpoint(d, _points(6), ALGOS, chunk_size=2)
    with pytest.raises(sweep.SweepResumeMismatch):
        sweep.SweepCheckpoint(d, _points(4), ALGOS, chunk_size=4)
    ck = sweep.SweepCheckpoint(d, _points(4), ALGOS, chunk_size=2)
    with pytest.raises(sweep.SweepResumeMismatch):
        next(sweep.run_grid_stream(_points(4), ("ogasched",), chunk_size=2, checkpoint=ck,
                                   device=CPU))


def test_stores_resume_across_packages(tmp_path):
    """A store the reference wrote binds the port's sweep of the same grid
    (same fingerprint, same layout), and the port reads its chunks; the
    reference accepts the port's store the same way."""
    algos = ("ogasched", "fairness")
    tpts, jpts = _both_grids(5)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck = jsweep.SweepCheckpoint(jd, jpts, algos, chunk_size=2)
    for sl, _, out in jsweep.run_grid_stream(jpts, algos, chunk_size=2, prefetch=0,
                                             checkpoint=jck):
        jck.commit(sl.start // 2, {k: np.asarray(v) for k, v in jsweep.summarize(out).items()})
        break
    tck = sweep.SweepCheckpoint(jd, tpts, algos, chunk_size=2)
    assert tck.fingerprint == jck.fingerprint and tck.completed_chunks() == 1
    (loaded,) = tck.load_summaries()
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, jck.load_summaries()[0][k])
    tck2 = sweep.SweepCheckpoint(td, tpts, algos, chunk_size=2)
    tck2.commit(0, loaded)
    assert jsweep.SweepCheckpoint(td, jpts, algos, chunk_size=2).completed_chunks() == 1


# ----------------------------------------------------------------- resume --
def _count_build_batch(monkeypatch):
    calls = []
    real = sweep.build_batch

    def counting(points, *a, **kw):
        calls.append(len(points))
        return real(points, *a, **kw)

    monkeypatch.setattr(sweep, "build_batch", counting)
    return calls


def test_resume_computes_only_missing_chunks(tmp_path, monkeypatch):
    """Stop a checkpointed sweep after 2 of 3 chunks: the rerun generates
    traces for the missing chunk only and gives the uninterrupted bits."""
    d = str(tmp_path)
    pts = _points(5)  # chunks [0, 1], [2, 3], [4] (padded)
    algos = ("ogasched", "fairness")
    ref = sweep.sweep_stream(pts, algos, chunk_size=2, device=CPU)
    ck = sweep.SweepCheckpoint(d, pts, algos, chunk_size=2)
    it = sweep.run_grid_stream(pts, algos, chunk_size=2, prefetch=0, checkpoint=ck, device=CPU)
    for i, (sl, _, out) in enumerate(it):
        ck.commit(sl.start // 2, sweep.summarize(out))
        if i == 1:
            break  # "crash" with chunk 2 unwritten
    it.close()
    assert ck.completed_chunks() == 2
    calls = _count_build_batch(monkeypatch)
    got = sweep.sweep_stream(pts, algos, chunk_size=2, prefetch=0, checkpoint_dir=d, device=CPU)
    assert calls == [1]  # only the final 1-point chunk was generated
    _assert_same_summary(got, ref)


def test_fully_checkpointed_sweep_is_pure_load(tmp_path, monkeypatch):
    d = str(tmp_path)
    pts = _points(4)
    algos = ("ogasched", "fairness")
    ref = sweep.sweep_stream(pts, algos, chunk_size=2, checkpoint_dir=d, device=CPU)
    calls = _count_build_batch(monkeypatch)
    got = sweep.sweep_stream(pts, algos, chunk_size=2, checkpoint_dir=d, device=CPU)
    assert calls == []
    _assert_same_summary(got, ref)


def test_torn_final_chunk_costs_exactly_one_chunk(tmp_path, monkeypatch):
    d = str(tmp_path)
    pts = _points(6)
    algos = ("ogasched", "fairness")
    ref = sweep.sweep_stream(pts, algos, chunk_size=2, checkpoint_dir=d, device=CPU)
    npz = os.path.join(d, "step_00000002.npz")
    with open(npz, "r+b") as f:  # tear the last chunk's payload
        f.truncate(os.path.getsize(npz) // 2)
    assert sweep.SweepCheckpoint(d, pts, algos, chunk_size=2).completed_chunks() == 2
    calls = _count_build_batch(monkeypatch)
    got = sweep.sweep_stream(pts, algos, chunk_size=2, prefetch=0, checkpoint_dir=d, device=CPU)
    assert calls == [2]
    _assert_same_summary(got, ref)
    assert C.verify_checkpoint(d, 2)


def test_lifecycle_resume_roundtrip(tmp_path):
    d = str(tmp_path)
    pts = _points(3)
    algos = ("ogasched", "fairness")
    ref = sweep.sweep_stream(pts, algos, chunk_size=2, mode="lifecycle", device=CPU)
    got = sweep.sweep_stream(pts, algos, chunk_size=2, mode="lifecycle", checkpoint_dir=d,
                             device=CPU)
    resumed = sweep.sweep_stream(pts, algos, chunk_size=2, mode="lifecycle",
                                 checkpoint_dir=d, device=CPU)
    _assert_same_summary(got, ref)
    _assert_same_summary(resumed, ref)


def test_stream_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.sweep_stream(_points(2), ("fairness",), chunk_size=2)
