"""The port's kernel wrappers and row layout against the reference.

On the CPU each wrapper computes its plain PyTorch version; these tests
hold that against the reference's Pallas kernels in interpret mode and its
jnp oracles. The CUDA kernels themselves run only on the card
(test_torch_cuda.py, chip_smoke.py).

Tolerances: atol 2e-5 against the Pallas fused step, the bar
test_kernels.py holds that kernel to against its own oracle; 1e-5 against
the reference's ``oga_step_ref`` (both exact projections, float32 order
of operations may differ); 1e-6 for the standalone projection, the
reference's oracle bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.oga_step import oga_step_fused as pallas_oga_step
from repro.kernels.sortscan import proj_sortscan as pallas_proj_sortscan
from repro_torch import convert
from repro_torch.core import ogasched
from repro_torch.kernels import autotune, build, ops
from repro_torch.kernels import oga_step as toga
from repro_torch.kernels import proj_bisect as tpb
from repro_torch.kernels import sortscan as tss
from repro_torch.kernels import ref as tref


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(2027, spawn_key=key))


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


@pytest.mark.parametrize("N,L", [(6, 10), (24, 48)])
def test_oga_step_plain_matches_pallas_interpret(N, L):
    args = _step_inputs(_rng(0, N, L), N, L, kinds=4)
    got = ops.oga_step_fused(*_torch(*args)).numpy()
    want = np.asarray(pallas_oga_step(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("N,L", [(14, 10), (21, 200)])
def test_oga_step_plain_matches_reference_ref_all_kinds(N, L):
    args = _step_inputs(_rng(1, N, L), N, L, kinds=7)
    got = ops.oga_step_fused(*_torch(*args)).numpy()
    want = np.asarray(jref.oga_step_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_proj_sortscan_plain_matches_pallas_interpret_and_oracle():
    rng = _rng(2)
    N, L = 16, 24
    z = (rng.normal(0, 5, (N, L))).astype(np.float32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    c = rng.uniform(0.3, 6.0, N).astype(np.float32)
    z[:, 1] = z[:, 0]   # duplicated breakpoints
    a[:, 1] = a[:, 0]
    m[3] = 0.0          # an empty row
    got = ops.proj_sortscan(*_torch(z, a, m, c)).numpy()
    want = np.asarray(pallas_proj_sortscan(*map(jnp.asarray, (z, a, m, c)), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, tref.proj_rows_exact_np(z, a, m, c), atol=1e-6)


def _spec_pair(rng, L, R, K):
    mask = (rng.random((L, R)) < 0.6).astype(np.float32)
    arrs = dict(
        mask=mask, a=rng.uniform(0.5, 4.0, (L, K)).astype(np.float32),
        c=rng.uniform(1.0, 9.0, (R, K)).astype(np.float32),
        alpha=rng.uniform(1.0, 1.5, (R, K)).astype(np.float32),
        beta=rng.uniform(0.3, 0.5, K).astype(np.float32),
        kinds=(np.arange(K) % 7).astype(np.int32),
    )
    return jgraph.ClusterSpec(**{k: jnp.asarray(v) for k, v in arrs.items()}), arrs


def test_row_layout_and_operands_match_reference():
    rng = _rng(3)
    L, R, K, G = 5, 6, 3, 2
    jspec, arrs = _spec_pair(rng, L, R, K)
    tspec = convert.spec_from_numpy(**arrs, device="cpu")
    y = rng.uniform(0, 2, (L, R, K)).astype(np.float32)
    rows = ops.pack_rows(torch.from_numpy(y))
    assert rows.is_contiguous()  # the kernels take contiguous rows only
    assert ops.pack_rows(ops.unpack_rows(rows, L, R, K)).data_ptr() == rows.data_ptr()
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jops.pack_rows(jnp.asarray(y))))
    np.testing.assert_array_equal(ops.unpack_rows(rows, L, R, K).numpy(), y)
    for got, want in zip(ops.pack_spec_operands(tspec), jops.pack_spec_operands(jspec)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ops._kstar_rows(tspec, torch.from_numpy(y)).numpy(),
        np.asarray(jops._kstar_rows(jspec, jnp.asarray(y))))
    # stacked: G configs, grid axis flattened into the rows
    jspec2, arrs2 = _spec_pair(rng, L, R, K)
    stacked = {k: np.stack([arrs[k], arrs2[k]]) for k in arrs}
    jst = jgraph.ClusterSpec(**{k: jnp.asarray(v) for k, v in stacked.items()})
    tst = convert.spec_from_numpy(**stacked, device="cpu")
    for got, want in zip(ops.pack_spec_operands_batch(tst), jops.pack_spec_operands_batch(jst)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    yb = rng.uniform(0, 2, (G, L, R, K)).astype(np.float32)
    assert ops.pack_rows(torch.from_numpy(yb)).shape == (G, R * K, L)
    assert ops.pack_rows(torch.from_numpy(yb)).is_contiguous()
    np.testing.assert_array_equal(
        ops.unpack_rows(ops.pack_rows(torch.from_numpy(yb)), L, R, K).numpy(), yb)
    np.testing.assert_array_equal(
        ops._kstar_rows(tst, torch.from_numpy(yb)).numpy().reshape(G * R * K, L),
        np.concatenate([np.asarray(jops._kstar_rows(jspec, jnp.asarray(yb[0]))),
                        np.asarray(jops._kstar_rows(jspec2, jnp.asarray(yb[1])))]))
    assert toga.SCAL_COLUMNS == ("alpha", "beta", "c", "kind", "eta")
    np.testing.assert_array_equal(
        toga.pack_scal(*_torch(*(np.full(3, v, np.float32) for v in (1, 2, 3, 4))), 5.0).numpy(),
        np.tile(np.arange(1, 6, dtype=np.float32), (3, 1)))


def test_launch_constants():
    assert autotune.slots_for(10) == autotune.WARP
    assert autotune.slots_for(100) == 256
    assert autotune.slots_for(autotune.MAX_L) == 2 * autotune.MAX_L
    assert autotune.row_threads(autotune.MAX_L, "bisect") == autotune.WIDE_THREADS
    with pytest.raises(ValueError):
        autotune.slots_for(autotune.MAX_L + 1)


def test_cuda_requests_raise_without_fallback(monkeypatch):
    """Without a card, a request for CUDA raises; no wrapper or entry point
    drops to the plain version, and no launch is counted."""
    counts = lambda: (toga.oga_step_fused.launches, tss.proj_sortscan.launches,
                      tpb.proj_bisect.launches)
    before = counts()
    meta = [torch.empty((4, 3), device="meta") for _ in range(5)]
    with pytest.raises(ValueError):
        ops.oga_step_fused(*meta, torch.empty((4, 5), device="meta"))
    with pytest.raises(ValueError):
        ops.proj_sortscan(*meta[:3], torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        ops.proj_bisect(*meta[:3], torch.empty(4, device="meta"))
    _, arrs = _spec_pair(_rng(4), 3, 4, 2)
    tspec = convert.spec_from_numpy(**arrs, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        ogasched.run(tspec, torch.ones((2, 3)), eta0=1.0, device="cuda")
    # build() refuses rather than returning something that is not the kernel
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    monkeypatch.setattr(build, "build_dir", lambda: build.Path("/nonexistent-build-dir"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert counts() == before
