"""OGASCHED, the heuristics and the regret machinery of the port against
the reference, on the same spec, arrivals and initial decision.

Tolerances: per-slot rewards within 1e-4 * max|reward| and the mean within
rtol 1e-5. The reference's own fused and reference backends differ per
slot by ~1e-5 relative on the Fig. 2 config: float32 rounding in another
order (XLA vs PyTorch sums, the segment a tie selects) moves a trajectory
by about that much and no more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core import baselines as jbase
from repro.core import graph as jgraph
from repro.core import ogasched as jog
from repro.core import regret as jregret
from repro.sched import trace as jtrace
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import ogasched as tog
from repro_torch.core import regret as tregret

CFG = dict(T=48, L=5, R=8, K=4, seed=3, contention=10.0)


def _problem(**kw):
    cfg = jtrace.TraceConfig(**{**CFG, **kw})
    jspec, jarr = jtrace.make(cfg)
    return jspec, jarr, convert.spec_from_reference(jspec, "cpu"), \
        convert.tensor_from_numpy(jarr, "cpu")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=what)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_ogasched_run_matches_reference(backend):
    jspec, jarr, tspec, tarr = _problem()
    rng = np.random.default_rng(np.random.SeedSequence(11))
    y0 = (rng.uniform(0, 1, (CFG["L"], CFG["R"], CFG["K"]))
          * np.asarray(jspec.mask)[:, :, None]).astype(np.float32)
    jr, jy = jog.run(jspec, jarr, eta0=5.0, decay=0.999, y0=jnp.asarray(y0), backend=backend)
    tr, ty = tog.run(tspec, tarr, eta0=5.0, decay=0.999, y0=torch.from_numpy(y0),
                     backend=backend, device="cpu")
    _close(tr.numpy(), jr, f"rewards/{backend}")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    # return_traj: the trajectory ends at y_final
    tr2, ty2, traj = tog.run(tspec, tarr, eta0=5.0, decay=0.999, y0=torch.from_numpy(y0),
                             backend=backend, return_traj=True, device="cpu")
    assert traj.shape == (CFG["T"], CFG["L"], CFG["R"], CFG["K"])
    np.testing.assert_array_equal(traj[-1].numpy(), ty2.numpy())
    np.testing.assert_array_equal(tr2.numpy(), tr.numpy())


def test_ogasched_run_batch_matches_reference():
    cfgs = [jtrace.TraceConfig(**{**CFG, "seed": s}) for s in (0, 1, 2)]
    jspec, jarr, _, _ = jtrace.make_batch(cfgs)
    tspec = convert.spec_from_reference(jspec, "cpu")
    eta0 = np.asarray([25.0, 10.0, 5.0], np.float32)
    decay = np.asarray([0.9999, 0.999, 0.99], np.float32)
    jr, jy = jog.run_batch(jspec, jarr, jnp.asarray(eta0), jnp.asarray(decay))
    tr, ty = tog.run_batch(tspec, convert.tensor_from_numpy(jarr, "cpu"),
                           torch.from_numpy(eta0), torch.from_numpy(decay), device="cpu")
    for g in range(3):
        _close(tr[g].numpy(), jr[g], f"config {g}")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(tog.eta_theoretical(tspec[0], 100).numpy(),
                               np.asarray(jog.eta_theoretical(
                                   jgraph.ClusterSpec(*(getattr(jspec, f)[0] for f in
                                                        tspec.FIELDS)), 100)), rtol=1e-6)


@pytest.mark.parametrize("name", ["drf", "fairness", "binpacking", "spreading"])
def test_baseline_matches_reference(name):
    jspec, jarr, tspec, tarr = _problem(rho=0.8)
    want = np.asarray(jbase.run(jspec, jarr, name))
    got = tbase.run(tspec, tarr, name, device="cpu").numpy()
    _close(got, want, name)


def test_offline_optimum_and_regret_match_reference():
    jspec, jarr, tspec, tarr = _problem()
    jy = jregret.offline_optimum(jspec, jarr, iters=200)
    ty = tregret.offline_optimum(tspec, tarr, iters=200, device="cpu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    online, _ = jog.run(jspec, jarr, eta0=25.0)
    t_online = convert.tensor_from_numpy(online, "cpu")
    np.testing.assert_allclose(
        float(tregret.regret(tspec, tarr, t_online, ty)),
        float(jregret.regret(jspec, jarr, online, jy)), rtol=1e-4)
    np.testing.assert_allclose(
        tregret.regret_curve(tspec, tarr, t_online, ty).numpy(),
        np.asarray(jregret.regret_curve(jspec, jarr, online, jy)), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(tregret.regret_bound(tspec, CFG["T"])),
                               float(jregret.regret_bound(jspec, CFG["T"])), rtol=1e-6)
    np.testing.assert_allclose(float(tregret.h_g(tspec)), float(jregret.h_g(jspec)), rtol=1e-6)
