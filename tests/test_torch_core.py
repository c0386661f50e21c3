"""The port's utilities, reward and projection against the reference.

Inputs are numpy arrays from SeedSequence-derived generators, handed to
``repro`` as jax arrays and to ``repro_torch`` as CPU tensors.
Tolerances: rtol 1e-6 for the elementwise and reduction code (float32,
summation order may differ between XLA and PyTorch); atol 1e-6 for the
exact projections, the bar the reference's own projection tests use
against the float64 oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import projection as jproj
from repro.core import reward as jreward
from repro.core import utilities as jutil
from repro_torch import convert
from repro_torch.core import graph as tgraph
from repro_torch.core import projection as tproj
from repro_torch.core import reward as treward
from repro_torch.core import utilities as tutil
from repro_torch.kernels import ref as tref


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(2026, spawn_key=key))


def _spec_arrays(rng, L=5, R=7, K=4, kinds=None):
    mask = (rng.random((L, R)) < 0.6).astype(np.float32)
    mask[np.arange(L), np.arange(L) % R] = 1.0
    return dict(
        mask=mask,
        a=rng.uniform(0.5, 4.0, (L, K)).astype(np.float32),
        c=rng.uniform(1.0, 9.0, (R, K)).astype(np.float32),
        alpha=rng.uniform(1.0, 1.5, (R, K)).astype(np.float32),
        beta=np.linspace(0.3, 0.5, K).astype(np.float32),
        kinds=(np.arange(K) % jutil.NUM_KINDS if kinds is None else kinds).astype(np.int32),
    )


def _both_specs(arrs):
    jspec = jgraph.ClusterSpec(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return jspec, convert.spec_from_numpy(**arrs, device="cpu")


def test_kind_tables_match():
    assert tutil.KIND_NAMES == jutil.KIND_NAMES
    assert tutil.NUM_SEED_KINDS == jutil.NUM_SEED_KINDS
    assert tutil.NUM_KINDS == jutil.NUM_KINDS


@pytest.mark.parametrize("kind", range(7))
def test_util_value_and_grad_every_kind(kind):
    rng = _rng(0, kind)
    y = rng.uniform(-0.5, 30.0, (6, 8)).astype(np.float32)
    alpha = rng.uniform(1.0, 1.5, (6, 8)).astype(np.float32)
    kinds = np.full((8,), kind, np.int32)
    for jf, tf in ((jutil.util_value, tutil.util_value), (jutil.util_grad, tutil.util_grad)):
        want = np.asarray(jf(jnp.asarray(kinds), jnp.asarray(alpha), jnp.asarray(y)))
        got = tf(torch.from_numpy(kinds), torch.from_numpy(alpha), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(jutil.util_grad_at_zero(jnp.asarray(kinds), jnp.asarray(alpha)))
    got = tutil.util_grad_at_zero(torch.from_numpy(kinds), torch.from_numpy(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_reward_grad_and_bounds_match_reference(seed):
    rng = _rng(1, seed)
    arrs = _spec_arrays(rng)
    jspec, tspec = _both_specs(arrs)
    L, R, K = arrs["mask"].shape + (arrs["a"].shape[1],)
    y = (rng.uniform(0.0, 3.0, (L, R, K)) * arrs["mask"][:, :, None]).astype(np.float32)
    x = (rng.random(L) < 0.7).astype(np.float32)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jf, tf in ((jreward.total_reward, treward.total_reward),
                   (jreward.port_rewards, treward.port_rewards),
                   (jreward.reward_grad, treward.reward_grad)):
        np.testing.assert_allclose(tf(tspec, tx, ty).numpy(), np.asarray(jf(jspec, jx, jy)),
                                   rtol=1e-6, atol=1e-5)
    for jf, tf in ((jreward.grad_norm_bound, treward.grad_norm_bound),
                   (jreward.diameter_bound, treward.diameter_bound)):
        np.testing.assert_allclose(tf(tspec).numpy(), np.asarray(jf(jspec)), rtol=1e-6)
    assert bool(tgraph.feasible(tspec, ty)) == bool(jgraph.feasible(jspec, jy))
    assert not bool(tgraph.feasible(tspec, ty + 100.0))


def test_reward_grad_kstar_tie_at_zero():
    """At y = 0 every beta_k sum_r y is 0: k* is the first index, in both."""
    arrs = _spec_arrays(_rng(2), L=4, R=5, K=3)
    arrs["beta"] = np.full(3, 0.4, np.float32)
    jspec, tspec = _both_specs(arrs)
    y = np.zeros((4, 5, 3), np.float32)
    x = np.ones(4, np.float32)
    got = treward.reward_grad(tspec, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jreward.reward_grad(jspec, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    m = arrs["mask"]
    # the penalty lands on resource 0 only
    assert np.all(got[:, :, 1:] * m[:, :, None] == want[:, :, 1:] * m[:, :, None])
    assert np.all((want[:, :, 0] < want[:, :, 1]) | (m == 0))


def _rows(rng, N, L, dup=False):
    z = rng.normal(0, 5, (N, L)).astype(np.float32)
    a = rng.uniform(0.05, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    c = rng.uniform(0.1, 8.0, N).astype(np.float32)
    if dup:  # duplicated breakpoints: repeated lanes and z = a
        z[:, 1::2] = z[:, ::2][:, : z[:, 1::2].shape[1]]
        a[:, 1::2] = a[:, ::2][:, : a[:, 1::2].shape[1]]
        z[:, :1] = a[:, :1]
    m[0] = 0.0             # an empty row
    c[1] = 0.0             # zero capacity
    z[2] = a[2] + 5.0      # every lane at its cap...
    c[2] = (a[2] * m[2]).sum() + 1.0  # ...and feasible: the box path
    return z, a, m, c


_ROW_FNS = ("project_rows_allpairs", "project_rows_sortscan", "project_rows_sorted")


@pytest.mark.parametrize("L,dup", [(1, False), (10, False), (10, True), (200, True)],
                         ids=["L1", "L10", "L10-duplicates", "L200-duplicates"])
def test_row_projections_match_reference_and_oracle(L, dup):
    z, a, m, c = _rows(_rng(3, L, int(dup)), 24, L, dup=dup)
    oracle = tref.proj_rows_exact_np(z, a, m, c)
    t_args = [torch.from_numpy(v) for v in (z, a, m, c)]
    j_args = [jnp.asarray(v) for v in (z, a, m, c)]
    for name in _ROW_FNS:
        got = getattr(tproj, name)(*t_args).numpy()
        np.testing.assert_allclose(got, oracle, atol=1e-6, err_msg=name)
        want = np.asarray(getattr(jproj, name)(*j_args))
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


def test_project_cluster_matches_reference():
    rng = _rng(4)
    arrs = _spec_arrays(rng, L=6, R=9, K=4)
    jspec, tspec = _both_specs(arrs)
    z = rng.normal(1.0, 4.0, (6, 9, 4)).astype(np.float32)
    got = tproj.project(tspec, torch.from_numpy(z)).numpy()
    want = np.asarray(jproj.project(jspec, jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert bool(tgraph.feasible(tspec, torch.from_numpy(got)))


def test_project_exact_np_is_the_reference_oracle():
    rng = _rng(5)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        z, a, c = rng.normal(0, 5, n), rng.uniform(0.05, 4.0, n), float(rng.uniform(0, 8))
        np.testing.assert_array_equal(tproj.project_exact_np(z, a, c),
                                      jproj.project_exact_np(z, a, c))
