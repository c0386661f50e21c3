"""Twin of ``tests/test_straggler.py`` on the port's scheduler, on the CPU:
OGASCHED learns around a degraded instance, whose realized reward gradient
shrinks, with no explicit blacklisting, and spreads load on a healthy
cluster. ``repro_torch.core.ogasched.run`` with the fused backend (its
plain version on the CPU), on the port's traces (bit for bit the
reference's). The final allocations are also held against the
reference's run on the same spec and arrivals, at 1e-4 of the largest
instance total (600 float32 slots apart).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import ogasched as jogasched
from repro.sched import trace as jtrace
from repro_torch.core import ogasched
from repro_torch.sched import trace

ALLOC_RTOL_OF_MAX = 1e-4


def _instance_totals(y_final) -> np.ndarray:
    return np.asarray(y_final).sum(axis=(0, 2))


def test_scheduler_shifts_allocation_away_from_degraded_instance():
    cfg = trace.TraceConfig(T=600, L=6, R=8, K=4, seed=0, density=1.0)
    spec = trace.build_spec(cfg, "cpu")
    arrivals = trace.build_arrivals(cfg, device="cpu")
    # instance 0 degrades: its per-unit computation gain collapses; instance
    # 1 is its healthy twin with the same capacity
    alpha, c = spec.alpha.clone(), spec.c.clone()
    alpha[0, :] = 0.02
    c[1] = c[0]
    spec_bad = dataclasses.replace(spec, alpha=alpha, c=c)
    _, y_final = ogasched.run(spec_bad, arrivals, eta0=25.0, decay=0.9999, device="cpu")
    alloc = _instance_totals(y_final)
    assert alloc[0] < 0.5 * alloc[1], (alloc[0], alloc[1])

    jspec = jtrace.build_spec(jtrace.TraceConfig(T=600, L=6, R=8, K=4, seed=0, density=1.0))
    jspec = dataclasses.replace(jspec, alpha=jnp.asarray(alpha.numpy()), c=jnp.asarray(c.numpy()))
    _, jy = jogasched.run(jspec, jnp.asarray(arrivals.numpy()), eta0=25.0, decay=0.9999)
    want = _instance_totals(jy)
    np.testing.assert_allclose(alloc, want, rtol=0, atol=ALLOC_RTOL_OF_MAX * want.max())


def test_healthy_cluster_spreads_load():
    cfg = trace.TraceConfig(T=300, L=6, R=8, K=4, seed=1, density=1.0)
    spec, arrivals = trace.make(cfg, "cpu")
    _, y_final = ogasched.run(spec, arrivals, eta0=25.0, decay=0.9999, device="cpu")
    alloc = _instance_totals(y_final)
    assert (alloc > 0).all()  # nobody starved on a healthy cluster
    assert isinstance(y_final, torch.Tensor) and y_final.shape == (6, 8, 4)
