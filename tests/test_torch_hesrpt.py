"""The port's size-aware baselines and their projections against the JAX
reference, on the CPU.

``hesrpt_shares`` against its closed form (arXiv:1903.09346 Thm. 1, from
the formula in numpy) at 1e-6 and against the reference's at 1e-6;
``fill_rows_to_capacity`` against the paper's Algorithm 1
(``project_alg1_np``, float64) on rows where the capacity binds, at 1e-5,
and against the reference's at 1e-5; the numpy oracles equal the
reference's copies bit for bit; slot-mode heSRPT and MULTICLASS rewards
(T 32, L 6, R 16, K 4) within rtol 1e-4 of the reference's (float32
projections in another order: 24 a slot).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import projection as jproj
from repro.sched import sweep as jsweep
from repro.sched import trace as jt
from repro_torch.core import baselines as tbase
from repro_torch.core import graph as tgraph
from repro_torch.core import projection as tproj
from repro_torch.core.graph import ClusterSpec
from repro_torch.kernels import ops as tops
from repro_torch.sched import sweep as tsweep
from repro_torch.sched import trace as tt

KW = dict(T=32, L=6, R=16, K=4, seed=2, contention=10.0)


def _shares_oracle(sizes, active, p):
    q = 1.0 / (1.0 - p)
    idx = np.where(active)[0]
    order = sorted(idx, key=lambda i: (-sizes[i], i))
    n = len(order)
    theta = np.zeros(sizes.shape, np.float64)
    for rank, i in enumerate(order, start=1):
        theta[i] = (rank / n) ** q - ((rank - 1) / n) ** q
    return theta


@pytest.mark.parametrize("p", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("seed", range(3))
def test_shares_match_closed_form(p, seed):
    rng = np.random.default_rng(seed)
    sizes = np.round(rng.lognormal(2.0, 1.0, 12), 1).astype(np.float32)  # ties
    active = rng.uniform(size=12) < 0.7
    active[0] = True
    got = tbase.hesrpt_shares(torch.from_numpy(sizes), torch.from_numpy(active), p=p).numpy()
    np.testing.assert_allclose(got, _shares_oracle(sizes, active, p), atol=1e-6)
    want = np.asarray(jbase.hesrpt_shares(jnp.asarray(sizes), jnp.asarray(active), p=p))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-5) and (got[~active] == 0).all()


@pytest.mark.parametrize("case", ["srpt", "equi", "scale_free", "batched"])
def test_shares_limits(case):
    if case == "srpt":  # p -> 1: the smallest job takes nearly everything
        th = tbase.hesrpt_shares(torch.tensor([9.0, 2.0, 30.0, 5.0]), torch.ones(4), p=0.99)
        assert int(th.argmax()) == 1 and float(th[1]) > 0.999
    elif case == "equi":  # p -> 0: an equal split over the active set
        act = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
        th = tbase.hesrpt_shares(torch.tensor([9.0, 2.0, 30.0, 5.0, 1.0]), act, p=0.0)
        np.testing.assert_allclose(th[act > 0].numpy(), 0.25, atol=1e-6)
    elif case == "scale_free":
        s = torch.from_numpy(np.random.default_rng(7).uniform(1.0, 50.0, 10).astype(np.float32))
        np.testing.assert_allclose(tbase.hesrpt_shares(s, torch.ones(10)).numpy(),
                                   tbase.hesrpt_shares(s * 37.5, torch.ones(10)).numpy(),
                                   atol=1e-6)
    else:  # a (G, L) batch equals its rows
        rng = np.random.default_rng(9)
        s = torch.from_numpy(rng.uniform(1.0, 9.0, (3, 8)).astype(np.float32))
        a = torch.from_numpy(rng.uniform(size=(3, 8)) < 0.6)
        got = tbase.hesrpt_shares(s, a)
        for g in range(3):
            assert torch.equal(got[g], tbase.hesrpt_shares(s[g], a[g]))


def _saturating_rows(seed, N=24, L=9):
    rng = np.random.default_rng((100, seed))
    z = rng.uniform(0.5, 5.0, (N, L)).astype(np.float32)   # heSRPT ideal points are >= 0
    a = rng.uniform(0.5, 4.0, (N, L)).astype(np.float32)
    m = (rng.uniform(size=(N, L)) < 0.8).astype(np.float32)
    m[:, 0] = 1.0
    c = (0.5 * (np.minimum(z, a) * m).sum(1)).astype(np.float32)  # binds on every row
    return z, a, m, c


@pytest.mark.parametrize("seed", range(4))
def test_fill_rows_matches_algorithm_1(seed):
    """Where the capacity binds, the saturating fill and the inequality
    projection are the same point: the paper's Algorithm 1 in float64."""
    z, a, m, c = _saturating_rows(seed)
    got = tproj.fill_rows_to_capacity(*map(torch.from_numpy, (z, a, m, c))).numpy()
    for i in range(len(z)):
        lanes = m[i] > 0
        want = np.zeros(z.shape[1])
        want[lanes] = tproj.project_alg1_np(z[i, lanes], a[i, lanes], float(c[i]))
        np.testing.assert_allclose(got[i], want, atol=1e-5, err_msg=f"row {i}")
        assert (got[i] * m[i]).sum() == pytest.approx(float(c[i]), abs=1e-4)
    want = np.asarray(jproj.fill_rows_to_capacity(*map(jnp.asarray, (z, a, m, c))))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fill_to_capacity_matches_reference():
    spec = tt.build_spec(tt.TraceConfig(**KW), device="cpu")
    jspec = jt.build_spec(jt.TraceConfig(**KW))
    z = np.random.default_rng(4).uniform(0.0, 30.0, (KW["L"], KW["R"], KW["K"])).astype(np.float32)
    got = tproj.fill_to_capacity(torch.from_numpy(z), spec.a, spec.c, spec.mask).numpy()
    want = np.asarray(jproj.fill_to_capacity(jnp.asarray(z), jspec.a, jspec.c, jspec.mask))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_numpy_oracles_are_the_references(seed):
    rng = np.random.default_rng(seed)
    z, a = rng.normal(2.0, 3.0, 11), rng.uniform(0.1, 4.0, 11)
    for c in (0.0, 1.5, 6.0, 1e3):
        np.testing.assert_array_equal(tproj.project_alg1_np(z, a, c), jproj.project_alg1_np(z, a, c))
        np.testing.assert_allclose(tproj.project_alg1_np(z, a, c), tproj.project_exact_np(z, a, c),
                                   atol=1e-9)
    spec = tt.build_spec(tt.TraceConfig(**KW), device="cpu")
    jspec = jt.build_spec(jt.TraceConfig(**KW))
    zc = rng.normal(5.0, 10.0, (KW["L"], KW["R"], KW["K"]))
    for method in ("exact", "alg1"):
        np.testing.assert_array_equal(tproj.project_cluster_np(spec, zc, method),
                                      jproj.project_cluster_np(jspec, zc, method))


def test_project_spec_rows_matches_project_sorted():
    """The lifecycle's projection entry: one call over the packed rows of a
    stacked spec equals ``project_sorted`` config by config."""
    specs = [tt.build_spec(tt.TraceConfig(**dict(KW, seed=s)), device="cpu") for s in (1, 2)]
    stacked = ClusterSpec.stack(specs)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(5.0, 20.0, (2, KW["L"], KW["R"], KW["K"])).astype(np.float32))
    c = torch.from_numpy(rng.uniform(0.0, 50.0, (2, KW["R"], KW["K"])).astype(np.float32))
    got = tproj.project_spec_rows(stacked, z, c, operands=tops.pack_spec_operands(stacked))
    for g, spec in enumerate(specs):
        assert torch.equal(got[g], tproj.project_sorted(z[g], spec.a, c[g], spec.mask))
        assert torch.equal(tproj.project_spec_rows(spec, z[g]),
                           tproj.project_sorted(z[g], spec.a, spec.c, spec.mask))


@pytest.mark.parametrize("name", tbase.OPTIMAL_BASELINES)
def test_slot_mode_rewards_match_reference(name):
    jspec, jarr, jworks = jt.make_lifecycle(jt.TraceConfig(**KW))
    tspec, tarr, tworks = tt.make_lifecycle(tt.TraceConfig(**KW), device="cpu")
    sized = name in tbase.SIZE_AWARE
    want = np.asarray(jbase.run(jspec, jarr, name, works=jworks if sized else None))
    got = tbase.run(tspec, tarr, name, device="cpu", works=tworks if sized else None)
    assert got.shape == (KW["T"],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    if sized:
        with pytest.raises(ValueError, match="size-aware"):
            tbase.run(tspec, tarr, name, device="cpu")


def test_hesrpt_step_feasible_and_inactive_zero():
    spec, arr, works = tt.make_lifecycle(tt.TraceConfig(T=40, L=8, R=24, K=6, seed=2),
                                         device="cpu")
    for t in (0, 7, 31):
        y = tbase.hesrpt_step(spec, arr[t], sizes=works[t])
        assert bool(tgraph.feasible(spec, y))
        assert (y[arr[t] == 0] == 0).all()


def test_size_aware_slot_grid_matches_reference():
    """Slot-mode heSRPT through ``run_grid`` (works plumbed) equals the
    reference's grid, and its rows equal ``run_algorithm``."""
    base = dict(KW, T=16)
    jpts = jsweep.make_grid(jt.TraceConfig(**base), seeds=(1, 2))
    tpts = tsweep.make_grid(tt.TraceConfig(**base), seeds=(1, 2))
    jb = jsweep.build_batch(jpts, with_works=True)
    tb = tsweep.build_batch(tpts, with_works=True, device="cpu")
    want = np.asarray(jsweep.run_grid(jb, ("hesrpt",))["hesrpt"])
    got = tsweep.run_grid(tb, ("hesrpt",))["hesrpt"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    for g in range(2):
        row = tsweep.run_algorithm(tb.spec[g], tb.arrivals[g], "hesrpt", works=tb.works[g],
                                   device="cpu")
        np.testing.assert_allclose(got[g].numpy(), row.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(row.abs().max()))
    with pytest.raises(ValueError, match="job sizes"):
        tsweep.run_grid(tsweep.build_batch(tpts, device="cpu"), ("hesrpt",))
