"""The port's CUDA kernels on the card: each against its plain PyTorch
version and the float64 oracle, the wrappers' checks, and a short run of
the main path through the kernels. Marked ``cuda``; on a host without a
card every test skips (the decision is made in a fixture, never at import).

Tolerances: 1e-5 for the fused step against its plain version (the
kernel's projection solves in float64, the plain one in float32); 1e-6
for the projection against the float64 oracle.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ogasched
from repro_torch.kernels import autotune, ops, ref
from repro_torch.sched import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(2028, spawn_key=key))


def _step_args(rng, N, L, dev):
    a = rng.uniform(0.5, 3.0, (N, L)).astype(np.float32)
    mask = (rng.random((N, L)) < 0.8).astype(np.float32)
    y = (np.minimum(rng.uniform(0.0, 2.0, (N, L)), a) * mask).astype(np.float32)
    x = (rng.random((N, L)) < 0.7).astype(np.float32)
    kstar = (rng.random((N, L)) < 0.2).astype(np.float32)
    scal = np.stack([
        rng.uniform(1.0, 1.5, N), rng.uniform(0.3, 0.5, N),
        rng.uniform(0.1, 0.8, N) * L, np.arange(N) % 7, np.full(N, 0.7),
    ], axis=1).astype(np.float32)
    return [torch.from_numpy(t).to(dev) for t in (y, a, mask, x, kstar, scal)]


@pytest.mark.parametrize("N,L", [(768, 10), (6144, 100), (37, 1), (64, 512)])
def test_oga_step_kernel_matches_plain(dev, N, L):
    args = _step_args(_rng(0, N, L), N, L, dev)
    before = ops.oga_step_fused.launches
    got = ops.oga_step_fused(*args)
    torch.cuda.synchronize()
    assert ops.oga_step_fused.launches == before + 1
    torch.testing.assert_close(got, ref.oga_step_ref(*args), atol=1e-5, rtol=0)


@pytest.mark.parametrize("N,L", [(256, 10), (256, 100), (64, 130)])
def test_proj_sortscan_kernel_matches_oracle(dev, N, L):
    rng = _rng(1, N, L)
    z = rng.normal(0.0, 5.0, (N, L)).astype(np.float32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    c = rng.uniform(0.3, 6.0, N).astype(np.float32)
    z[:16, 1] = z[:16, 0]
    a[:16, 1] = a[:16, 0]
    m[16:20] = 0.0
    c[20] = 0.0
    got = ops.proj_sortscan(*(torch.from_numpy(t).to(dev) for t in (z, a, m, c)))
    np.testing.assert_allclose(got.cpu().numpy(), ref.proj_rows_exact_np(z, a, m, c),
                               atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    args = _step_args(_rng(2), 8, 10, dev)
    with pytest.raises(TypeError):
        ops.oga_step_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        ops.oga_step_fused(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError):
        ops.oga_step_fused(*args[:-1], args[-1].cpu())
    wide = autotune.MAX_L + 1
    z = torch.zeros((2, wide), device=dev)
    with pytest.raises(ValueError):
        ops.proj_sortscan(z, z, z, torch.zeros(2, device=dev))


def test_ogasched_run_on_the_card_matches_cpu(dev):
    cfg = trace.TraceConfig(T=64, L=6, R=16, K=4, seed=1)
    spec, arr = trace.make(cfg, device="cpu")
    before = ops.oga_step_fused.launches
    got, y_got = ogasched.run(spec, arr, eta0=25.0, device=dev)
    assert ops.oga_step_fused.launches == before + cfg.T
    want, y_want = ogasched.run(spec, arr, eta0=25.0, device="cpu")
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(y_got.cpu().numpy(), y_want.numpy(), atol=1e-4)
