"""The port's bisection projection against the reference, on the CPU.

On the CPU ``proj_bisect`` and the fused step's ``method="bisect"`` branch
compute their plain versions (``ref.proj_rows_bisect``,
``ref.oga_step_ref(proj="bisect")``); these tests hold them against the
reference's Pallas kernels in interpret mode, its jnp bisections and the
float64 oracle. The CUDA kernels run only on the card
(test_torch_cuda.py, chip_smoke.py).

Tolerances: 2e-6 between the port's and the reference's seeded bisection
(the same float32 algorithm at the same ``iters``, row sums taken in
another order: a few ulp at |z| <= 20); 5e-5 against the float64 oracle,
the reference's bar for its bisect kernel (bracket width / 2^iters);
2e-5 for the fused bisect branch against the Pallas kernel, the bar
tests/test_kernels.py holds that branch to; 1e-6 for the spec-level
64-iteration bisection, which converges to float32 precision.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import projection as jproj
from repro.kernels import ref as jref
from repro.kernels.oga_step import oga_step_fused as pallas_oga_step
from repro.kernels.proj_bisect import proj_bisect as pallas_proj_bisect
from repro_torch import convert
from repro_torch.core import projection as tproj
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import oga_step as toga
from repro_torch.kernels import proj_bisect as tpb
from repro_torch.kernels import ref as tref

SHAPES = [(4, 8), (16, 24), (33, 130), (8, 1)]  # tests/test_kernels.py's
SAME_ALGORITHM_ATOL = 2e-6
ORACLE_ATOL = 5e-5


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(2029, spawn_key=key))


def _proj_inputs(rng, N, L, scale=5.0):
    z = (rng.normal(0.0, 1.0, (N, L)) * scale).astype(np.float32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    c = rng.uniform(0.3, 6.0, N).astype(np.float32)
    return z, a, m, c


def _step_inputs(rng, N, L, kinds):
    y = rng.uniform(0.0, 2.0, (N, L)).astype(np.float32)
    a = rng.uniform(0.5, 3.0, (N, L)).astype(np.float32)
    mask = (rng.random((N, L)) < 0.8).astype(np.float32)
    y = np.minimum(y, a) * mask
    x = (rng.random((N, L)) < 0.7).astype(np.float32)
    kstar = (rng.random((N, L)) < 0.2).astype(np.float32)
    scal = np.stack([
        rng.uniform(1.0, 1.5, N), rng.uniform(0.3, 0.5, N),
        rng.uniform(1.0, 8.0, N), np.arange(N) % kinds, np.full(N, 0.7),
    ], axis=1).astype(np.float32)
    return y, a, mask, x, kstar, scal


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("iters", autotune.BISECT_ITERS)
@pytest.mark.parametrize("N,L", SHAPES)
def test_proj_rows_bisect_matches_pallas_interpret(N, L, iters):
    args = _proj_inputs(_rng(0, N, L), N, L)
    got = tref.proj_rows_bisect(*_torch(*args), iters=iters).numpy()
    want = np.asarray(pallas_proj_bisect(*map(jnp.asarray, args), iters=iters,
                                         interpret=True))
    np.testing.assert_allclose(got, want, atol=SAME_ALGORITHM_ATOL)


@pytest.mark.parametrize("iters", autotune.BISECT_ITERS)
@pytest.mark.parametrize("N,L", SHAPES)
def test_both_bisections_meet_the_exact_oracle(N, L, iters):
    args = _proj_inputs(_rng(1, N, L), N, L)
    oracle = tref.proj_rows_exact_np(*args)
    np.testing.assert_allclose(oracle, jref.proj_rows_exact_np(*args), atol=0)
    got = tpb.proj_bisect(*_torch(*args), iters=iters).numpy()
    want = np.asarray(pallas_proj_bisect(*map(jnp.asarray, args), iters=iters,
                                         interpret=True))
    np.testing.assert_allclose(got, oracle, atol=ORACLE_ATOL)
    np.testing.assert_allclose(want, oracle, atol=ORACLE_ATOL)


def test_wide_tau_range_at_the_default_iters():
    """The seeded bracket and the secant finish keep 20 halvings at the
    oracle's accuracy even with tau spread wide (the reference's
    test_proj_bisect_reduced_iters_accuracy distribution)."""
    rng = _rng(2)
    z = (rng.normal(0.0, 20.0, (64, 48))).astype(np.float32)
    a = rng.uniform(0.05, 4.0, (64, 48)).astype(np.float32)
    m = np.ones((64, 48), np.float32)
    c = rng.uniform(0.2, 10.0, 64).astype(np.float32)
    got = ops.proj_bisect(*_torch(z, a, m, c)).numpy()
    np.testing.assert_allclose(got, tref.proj_rows_exact_np(z, a, m, c), atol=2e-5)
    assert (got.sum(1) <= c + 1e-4).all()


@pytest.mark.parametrize("seed", range(10))
def test_proj_bisect_is_feasible(seed):
    rng = _rng(3, seed)
    z = (rng.normal(0.0, 10.0, (8, 16))).astype(np.float32)
    a = rng.uniform(0.05, 3.0, (8, 16)).astype(np.float32)
    m = (rng.random((8, 16)) < 0.7).astype(np.float32)
    c = rng.uniform(0.1, 5.0, 8).astype(np.float32)
    y = tpb.proj_bisect(*_torch(z, a, m, c)).numpy()
    assert (y >= 0).all() and (y <= a).all()
    assert (y[m == 0] == 0).all()
    assert (y.sum(1) <= c + 1e-4).all()


@pytest.mark.parametrize("N,L", SHAPES)
def test_proj_rows_ref_matches_reference(N, L):
    """The unseeded 64-iteration oracle of the reference, ported."""
    args = _proj_inputs(_rng(4, N, L), N, L)
    got = tref.proj_rows_ref(*_torch(*args)).numpy()
    want = np.asarray(jref.proj_rows_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=SAME_ALGORITHM_ATOL)
    np.testing.assert_allclose(got, tref.proj_rows_exact_np(*args), atol=ORACLE_ATOL)


@pytest.mark.parametrize("iters", autotune.BISECT_ITERS)
@pytest.mark.parametrize("N,L", [(6, 10), (24, 48), (33, 130)])
def test_oga_step_bisect_plain_matches_pallas_interpret(N, L, iters):
    """Utility kinds 0-3 only: the Pallas gradient covers four (ROADMAP
    Queue 3, item 2)."""
    args = _step_inputs(_rng(5, N, L), N, L, kinds=4)
    got = toga.oga_step_fused(*_torch(*args), method="bisect", iters=iters).numpy()
    want = np.asarray(pallas_oga_step(*map(jnp.asarray, args), method="bisect",
                                      iters=iters, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5)
    exact = toga.oga_step_fused(*_torch(*args)).numpy()
    np.testing.assert_allclose(got, exact, atol=ORACLE_ATOL)


def test_pinned_bisect_runs_the_bisect_plain_version_on_the_cpu():
    args = _torch(*_step_inputs(_rng(6), 14, 10, kinds=7))
    pin = autotune.KernelConfig(4, "bisect", 12)
    got = ops.oga_step_fused(*args, tiling=pin)
    assert torch.equal(got, tref.oga_step_ref(*args, proj="bisect", iters=12))
    assert torch.equal(ops.oga_step_fused(*args), tref.oga_step_ref(*args))
    z, a, m, c = _torch(*_proj_inputs(_rng(7), 9, 12))
    assert torch.equal(ops.proj_bisect(z, a, m, c, tiling=pin),
                       tref.proj_rows_bisect(z, a, m, c, iters=12))
    assert torch.equal(ops.proj_bisect(z, a, m, c),
                       tref.proj_rows_bisect(z, a, m, c, iters=autotune.DEFAULT_BISECT_ITERS))


def test_unknown_methods_raise():
    args = _torch(*_step_inputs(_rng(8), 4, 6, kinds=4))
    with pytest.raises(ValueError):
        toga.oga_step_fused(*args, method="newton")
    with pytest.raises(ValueError):
        tref.oga_step_ref(*args, proj="newton")
    with pytest.raises(ValueError):
        toga.oga_step_fused(*args, method="bisect", iters=autotune.MAX_BISECT_ITERS + 1)


def _spec_pair(rng, L, R, K):
    arrs = dict(
        mask=(rng.random((L, R)) < 0.6).astype(np.float32),
        a=rng.uniform(0.5, 4.0, (L, K)).astype(np.float32),
        c=rng.uniform(0.5, 6.0, (R, K)).astype(np.float32),
        alpha=rng.uniform(1.0, 1.5, (R, K)).astype(np.float32),
        beta=rng.uniform(0.3, 0.5, K).astype(np.float32),
        kinds=(np.arange(K) % 7).astype(np.int32),
    )
    jspec = jgraph.ClusterSpec(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return jspec, convert.spec_from_numpy(**arrs, device="cpu")


@pytest.mark.parametrize("iters", [20, 64])
@pytest.mark.parametrize("L,R,K", [(5, 6, 3), (12, 16, 4)])
def test_project_bisect_matches_reference(L, R, K, iters):
    rng = _rng(9, L, iters)
    jspec, tspec = _spec_pair(rng, L, R, K)
    z = (rng.normal(0.0, 3.0, (L, R, K))).astype(np.float32)
    got = tproj.project(tspec, torch.from_numpy(z), iters=iters, method="bisect").numpy()
    want = np.asarray(jproj.project(jspec, jnp.asarray(z), iters=iters, method="bisect"))
    np.testing.assert_allclose(got, want, atol=1e-6)
    if iters == 64:
        exact = tproj.project(tspec, torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, exact, atol=1e-5)


def test_project_rejects_unknown_methods():
    _, tspec = _spec_pair(_rng(10), 3, 2, 2)
    assert tproj.PROJECT_METHODS == jproj.PROJECT_METHODS
    with pytest.raises(ValueError):
        tproj.project(tspec, torch.zeros((3, 2, 2)), method="newton")


def test_proj_bisect_bf16():
    """bf16 z, a, mask and c (the reference's test_proj_bisect_bf16): the
    result is bf16, within 0.3 of the float64 oracle on the float32 casts
    (the reference's bar: bf16 inputs of size ~5 round by up to 0.016 and
    the water level moves with them), and within two bf16 ulps at |y| < 4
    (2^-5) of the reference's Pallas kernel on the same bf16 inputs: both
    solve in float32 and round once at the end."""
    rng = _rng(40)
    z, a, _, c = _proj_inputs(rng, 16, 32)
    m = np.ones_like(z)
    tz, ta, tm, tc = (torch.from_numpy(t).to(torch.bfloat16) for t in (z, a, m, c))
    got = tpb.proj_bisect(tz, ta, tm, tc)
    assert got.dtype == torch.bfloat16
    want = tref.proj_rows_exact_np(tz.float().numpy(), ta.float().numpy(), m,
                                   tc.float().numpy())
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.3)
    jz, ja, jm, jc = (jnp.asarray(t).astype(jnp.bfloat16) for t in (z, a, m, c))
    pallas = np.asarray(pallas_proj_bisect(jz, ja, jm, jc, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=2 ** -5)
