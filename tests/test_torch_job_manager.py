"""The port's job manager (``repro_torch.sched.job_manager``) and mesh
planner (``repro_torch.launch.elastic.plan_mesh``) against the reference.

``build_cluster`` and ``templates_from_dryrun`` bit for bit (numpy draws
from the same "cluster" stream); the grants of 40 slots of
examples/elastic_cluster.py's scenario exactly (the port runs the fused
update, the reference its spec-level backend: the decisions differ by
float32 rounding, the power-of-two grants not at all); ``plan_mesh``
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import chip_smoke
from repro.launch import elastic as jelastic
from repro.sched import job_manager as jjm
from repro.sched import trace as jtrace
from repro_torch.launch.elastic import plan_mesh
from repro_torch.sched import job_manager, trace


def _templates(pkg):
    return [pkg.JobTemplate(arch=a, chips=c, hbm_gb=h) for a, c, h in chip_smoke.EXT_JOBS]


@pytest.mark.parametrize("n_hosts,seed", [(64, 0), (16, 3)])
def test_build_cluster_bit_for_bit(n_hosts, seed):
    want = jjm.build_cluster(_templates(jjm), n_hosts=n_hosts, seed=seed)
    got = job_manager.build_cluster(_templates(job_manager), n_hosts=n_hosts, seed=seed,
                                    device="cpu")
    for f in got.FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert job_manager.RES == jjm.RES


def test_job_manager_cluster_stream_discipline():
    """The port's counterpart of tests/test_trace.py's: the "cluster"
    stream, deterministic per seed, distinct across seeds and from a raw
    default_rng(seed)."""
    jobs = [job_manager.JobTemplate(arch=f"a{i}", chips=4.0, hbm_gb=8.0) for i in range(3)]
    s1 = job_manager.build_cluster(jobs, n_hosts=16, seed=0, device="cpu")
    s2 = job_manager.build_cluster(jobs, n_hosts=16, seed=0, device="cpu")
    for f in s1.FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f))
    s3 = job_manager.build_cluster(jobs, n_hosts=16, seed=1, device="cpu")
    assert not torch.equal(s1.c, s3.c)
    K = len(job_manager.RES)
    raw = np.random.default_rng(0).uniform(0.9, 1.1, (16, K))
    stream = trace.stream_rng(0, "cluster").uniform(0.9, 1.1, (16, K))
    assert not np.array_equal(raw, stream)
    np.testing.assert_allclose(s1.c.numpy(), np.array([4.0, 64.0, 16.0, 96.0, 256.0, 100.0])
                               * stream, rtol=1e-6)


def test_templates_from_dryrun_match():
    records = {"qwen2-72b": {"memory": {"argument_size_in_bytes": 3.0e10,
                                        "temp_size_in_bytes": 1.2e10}},
               "kimi": {"memory": {"argument_size_in_bytes": 9.0e10}},
               "bare": {}}
    want = jjm.templates_from_dryrun(records)
    got = job_manager.templates_from_dryrun(records)
    assert [t.__dict__ for t in got] == [t.__dict__ for t in want]
    assert [t.hbm_gb for t in got] == [42.0, 64.0, 0.0]
    np.testing.assert_array_equal(got[0].vector(), want[0].vector())


def test_job_manager_grants_match_reference():
    """40 slots of examples/elastic_cluster.py's scenario: every slot's
    grants equal the reference's, and each is a power of two."""
    jspec = jjm.build_cluster(_templates(jjm), n_hosts=chip_smoke.EXT_HOSTS, seed=0)
    jmgr = jjm.JobManager(jspec, _templates(jjm))
    tspec = job_manager.build_cluster(_templates(job_manager), n_hosts=chip_smoke.EXT_HOSTS,
                                      seed=0, device="cpu")
    tmgr = job_manager.JobManager(tspec, _templates(job_manager), device="cpu")
    n_grants = 0
    for x in chip_smoke.job_arrivals():
        want = jmgr.step(jnp.asarray(x))
        got = tmgr.step(x)
        assert got == want
        assert set(got) == {j.arch for j, xi in zip(_templates(jjm), x) if xi > 0}
        assert all(g == 0 or g & (g - 1) == 0 for g in got.values())
        n_grants += len(got)
    assert n_grants > 80
    np.testing.assert_allclose(tmgr.state.y.numpy(), np.asarray(jmgr.state.y), atol=1e-4)


def test_job_manager_matches_chip_smoke_pins():
    """chip_smoke.py's job-manager runner on the CPU gives the pinned
    grants and meshes (EXTENSIONS_REFERENCE, tests/_extensions_pins.py)."""
    got = chip_smoke.job_manager_run(torch, "cpu")
    ref = chip_smoke.EXTENSIONS_REFERENCE["jobs"]
    assert got["grants"] == ref["grants"]
    assert got["meshes"] == ref["meshes"]
    assert got["shape"] == [chip_smoke.EXT_HOSTS * len(job_manager.RES), len(chip_smoke.EXT_JOBS)]


@pytest.mark.parametrize("n,want", [(64, (4, 16)), (16, (1, 16)), (100, (4, 16)), (8, (1, 8))])
def test_plan_mesh_power_of_two(n, want):
    """The reference's four cases (tests/test_elastic.py)."""
    assert plan_mesh(n) == want == jelastic.plan_mesh(n)


def test_plan_mesh_matches_reference_everywhere():
    for n in range(1, 300):
        for model in (None, 1, 2, 4, 8, 16, 32):
            assert plan_mesh(n, model) == jelastic.plan_mesh(n, model), (n, model)


def test_trace_streams_unchanged():
    assert trace.STREAMS == jtrace.STREAMS


def test_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch):
    """No ``device=`` means the CUDA card: without one build_cluster and
    JobManager raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = _templates(job_manager)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        job_manager.build_cluster(jobs, n_hosts=8)
    spec = job_manager.build_cluster(jobs, n_hosts=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        job_manager.JobManager(spec, jobs)
