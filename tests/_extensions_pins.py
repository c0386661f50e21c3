"""The JAX reference's readings of the extensions path that chip_smoke.py
pins.

Runs the reference on the CPU at chip_smoke.py's configurations of
(a) §3.4 (Fig. 2's config with Poisson counts expanded to L*J ports:
J and the average reward), (b) §3.5 (the gang setup over EXT_GANG_T
slots: Σ q_t and every slot's kept-port mask, packed) and (d) the job
manager (examples/elastic_cluster.py's scenario: every slot's grants and
plan_mesh of each grant), and prints chip_smoke.py's EXTENSIONS_REFERENCE.
Run from the repo root (about a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_extensions_pins.py

With ``--port`` it also runs the port's plain path on the CPU through
chip_smoke.py's own runners and prints its errors against those readings
(``chip_smoke.extension_errors``): the yardstick of the card's bars.
With ``--sensitivity`` it prints the reference's own drift at (a) under a
one-ulp change of c, a or alpha (~6 minutes): why chip_smoke.py also
holds (a)'s first EXT_MULTI_PREFIX slots.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from repro.core import extensions, graph, ogasched  # noqa: E402
from repro.launch.elastic import plan_mesh  # noqa: E402
from repro.sched import job_manager, trace  # noqa: E402


def multi() -> dict:
    cfg = trace.TraceConfig(**cs.EXT_MULTI_CFG)
    spec = trace.build_spec(cfg)
    arr = trace.build_arrivals(cfg, multi=True)
    J = int(jnp.max(arr))
    espec, x_exp = extensions.expand_multi_arrival(spec, arr, J)
    rewards, y = ogasched.run(espec, x_exp, eta0=cs.EXT_ETA0, decay=cs.EXT_DECAY)
    assert bool(graph.feasible(espec, y))
    rewards = np.asarray(rewards)
    return {"J": J, "avg_reward": float(rewards.mean()),
            "prefix": cs.pack_floats(rewards[:cs.EXT_MULTI_PREFIX])}


def multi_sensitivity() -> dict:
    """The reference's own drift at (a) when c, a or alpha moves by one
    float32 ulp up or down: the average's relative change and the first
    slot whose reward parts from the unperturbed run's by more than
    TRAJ_TOL of its largest."""
    cfg = trace.TraceConfig(**cs.EXT_MULTI_CFG)
    spec = trace.build_spec(cfg)
    arr = trace.build_arrivals(cfg, multi=True)
    espec, x_exp = extensions.expand_multi_arrival(spec, arr, int(jnp.max(arr)))
    run = lambda s: np.asarray(ogasched.run(s, x_exp, eta0=cs.EXT_ETA0, decay=cs.EXT_DECAY)[0])
    base = run(espec)
    out = {}
    for field in ("c", "a", "alpha"):
        v = np.asarray(getattr(espec, field))
        for sign, to in (("+", np.inf), ("-", -np.inf)):
            r = run(dataclasses.replace(espec, **{field: jnp.asarray(np.nextafter(v, to))}))
            parted = np.nonzero(np.abs(r - base) > cs.TRAJ_TOL * np.abs(base).max())[0]
            out[field + sign] = {"avg_rel": float(abs(r.mean() - base.mean()) / abs(base.mean())),
                                 "first_parted_slot": int(parted[0]) if parted.size else None}
    return out


def gang() -> dict:
    cfg = trace.TraceConfig(**cs.EXT_MULTI_CFG)
    spec, arr = trace.make(cfg)
    req = cs.gang_task_requests(spec.L, spec.K)
    espec, pot, _ = extensions.expand_gang(spec, req)
    m_min = jnp.asarray(cs.gang_m_min(req))
    eta = jnp.asarray(cs.EXT_GANG_ETA)
    step = jax.jit(lambda y, x: extensions.gang_oga_step(espec, x, y, eta, pot, m_min, spec.L))
    y = jnp.zeros((espec.L, espec.R, espec.K))
    qs, kept = [], []
    for t in range(cs.EXT_GANG_T):
        y, q = step(y, arr[t])
        qs.append(np.asarray(q))
        n_sched = (np.asarray(jnp.sum(y, axis=(1, 2))) > 1e-6).reshape(spec.L, cs.EXT_GANG_Q)
        kept.append(n_sched.sum(1) >= np.asarray(m_min))
    return {"sum_q": float(np.asarray(qs, np.float32).sum(dtype=np.float64)),
            "kept": cs.pack_bits(np.stack(kept))}


def jobs() -> dict:
    tmpl = [job_manager.JobTemplate(arch=a, chips=c, hbm_gb=h) for a, c, h in cs.EXT_JOBS]
    spec = job_manager.build_cluster(tmpl, n_hosts=cs.EXT_HOSTS, seed=0)
    mgr = job_manager.JobManager(spec, tmpl)
    grants = []
    for x in cs.job_arrivals():
        g = mgr.step(jnp.asarray(x))
        grants.append([g.get(j.arch, -1) for j in tmpl])
    meshes = {str(g): list(plan_mesh(g)) for g in sorted({g for row in grants for g in row})
              if g > 0}
    return {"grants": grants, "meshes": meshes}


def main() -> None:
    pins = {"multi": multi(), "gang": gang(), "jobs": jobs()}
    print("EXTENSIONS_REFERENCE = " + json.dumps(pins))
    if "--sensitivity" in sys.argv[1:]:
        print("reference one-ulp drift at (a): " + json.dumps(multi_sensitivity()))
    if "--port" in sys.argv[1:]:
        import torch

        errs = cs.extension_errors(cs.multi_arrival_run(torch, "cpu"), cs.gang_run(torch, "cpu"),
                                   cs.job_manager_run(torch, "cpu"), pins)
        print("port on the CPU: " + json.dumps(errs))


if __name__ == "__main__":
    main()
