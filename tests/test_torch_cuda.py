"""The port's CUDA kernels on the card: each against its plain PyTorch
version and the float64 oracle, the wrappers' checks, the tiling (rows per
block) and the tuner, and a short run of the main path through the
kernels. Marked ``cuda``; on a host without a card every test skips (the
decision is made in a fixture, never at import).

Tolerances: 1e-5 for the fused step against its plain version (the
kernel's projection solves in float64, the plain one in float32); 1e-6
for the sortscan projection against the float64 oracle; 5e-5 for every
bisection result (the reference's bar for its bisect kernel: the bracket
width / 2^iters); none across row blocks, where the outputs are equal bit
for bit, nor between the sortscan kernels and the float64 emulation of
their register network (tests/_sortscan_network.py), nor between the
bisect projection and the float32 emulation of its sums' order
(tests/_bisect_network.py), which must agree bit for bit. Rows wider than 256 lanes (one block a row, slots in shared
memory) at 1e-6 against the float64 oracle on every row, 2e-6 against the
plain version and the fused step at 1e-5 against its plain version, both
run on CPU copies of the inputs; rows of zero capacity or of z = 0 come
back exactly 0.
bf16 bisection: 2^-5 against the plain version (two bf16 ulps at
|y| < 4; both solve in float32 and round once). Flash attention against
its plain version: 2e-5 in float32 (the FFMA kernel; the reference's
bar; the kernel sums in another order); in bf16 (the tensor-core kernel)
min(0.05, 1e-4 + 2^-6 |o| + 2^-8 |o|_abs), elementwise, with |o|_abs the
plain version run on |v|: the kernel rounds P once to bf16 before the PV
product (<= 2^-9 relative per p, so <= 2^-9 |o|_abs on o; doubled), and
both round the output once (a flip is one ulp <= 2^-7 |o|); 0.05 is the
reference's bf16 bar (tests/test_torch_flash_numerics.py holds the
derivation on the CPU); the LM on the
card against the CPU in float32: 1e-3 on logits at head dim 64 (float32
matmuls in another order, three layers deep, logits of size ~1-30), 1e-4
for the reduced configs as they are (head dim 16, d_model 64: the CPU
tests' bar), the other families' reduced configs also through 8 decode
steps, with their caches (K/V, the SSM's conv window and state) within
1e-4 of their largest magnitude. The job lifecycle
on the card against the same run on the CPU: events exactly, rewards and
occupancy within 1e-4 of their largest (the card's projection solves in
double, the CPU's in float32). The extensions path: the fused step at its
packed shapes at 1e-5; the §3.2 step on 1 and 4 shards against the
unsharded step (y bit for bit on one shard, 2e-5 on four, q 1e-5); §3.5's
kept masks equal to the CPU's; the int8 KV cache's codes within one step
of the CPU's and its decode within 1e-4 plus chip_smoke.INT8_FLIP_LOGIT a
differing code.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import _bisect_network as bnet
import _sortscan_network as net
from repro_torch import spans
from repro_torch.core import ogasched, slot_graph
from repro_torch.configs import base as tconfigs
from repro_torch.kernels import _launch, autotune, ops, ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import oga_step as toga
from repro_torch.kernels import proj_bisect as tpb
from repro_torch.kernels import sortscan as tss
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.sched import lifecycle, sweep, trace

BISECT_ATOL = 5e-5

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
    before = toga.oga_step_fused.launches
    got = ops.oga_step_fused(*args)
    torch.cuda.synchronize()
    assert toga.oga_step_fused.launches == before + 1
    torch.testing.assert_close(got, ref.oga_step_ref(*args), atol=1e-5, rtol=0)


@pytest.mark.parametrize("N,L", [(256, 10), (256, 100), (64, 130), (768, 10), (6144, 100)])
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
    before = toga.oga_step_fused.launches
    got, y_got = ogasched.run(spec, arr, eta0=25.0, device=dev)
    assert toga.oga_step_fused.launches == before + cfg.T
    want, y_want = ogasched.run(spec, arr, eta0=25.0, device="cpu")
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(y_got.cpu().numpy(), y_want.numpy(), atol=1e-4)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh, empty autotune table for the test."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    autotune.reset_cache()
    autotune.reset_stats()
    yield tmp_path
    autotune.reset_cache()
    autotune.reset_stats()


def _proj_args(rng, N, L):
    """The reference's projection-test distribution, with rows the
    capacity does not bind (c large), duplicated breakpoints, z = a lanes
    and fully masked rows."""
    z = rng.normal(0.0, 5.0, (N, L)).astype(np.float32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    c = rng.uniform(0.3, 6.0, N).astype(np.float32)
    c[::3] = 1e4
    z[:N // 4, 1::2] = z[:N // 4, 0:L - 1:2]
    a[:N // 4, 1::2] = a[:N // 4, 0:L - 1:2]
    z[:N // 4, 0] = a[:N // 4, 0]
    m[N // 4: N // 4 + 3] = 0.0
    return z, a, m, c


def _feasible(y, a, m, c):
    assert (y >= 0).all() and (y <= a).all()
    assert (y[m == 0] == 0).all()
    assert ((y * m).sum(1) <= c + 1e-4).all()


@pytest.mark.parametrize("N,L", [(768, 10), (6144, 100), (37, 1), (64, 512)])
def test_proj_bisect_kernel_matches_plain_and_oracle(dev, N, L):
    z, a, m, c = _proj_args(_rng(3, N, L), N, L)
    args = [torch.from_numpy(t).to(dev) for t in (z, a, m, c)]
    before = tpb.proj_bisect.launches
    got = ops.proj_bisect(*args)
    torch.cuda.synchronize()
    assert tpb.proj_bisect.launches == before + 1
    torch.testing.assert_close(got, ref.proj_rows_bisect(*args), atol=BISECT_ATOL, rtol=0)
    y = got.cpu().numpy()
    np.testing.assert_allclose(y, ref.proj_rows_exact_np(z, a, m, c), atol=BISECT_ATOL)
    _feasible(y, a, m, c)


@pytest.mark.parametrize("N,L", [(768, 10), (6144, 100), (37, 1), (64, 512)])
def test_oga_step_bisect_branch_matches_plain_and_sortscan(dev, N, L):
    args = _step_args(_rng(4, N, L), N, L, dev)
    for iters in autotune.BISECT_ITERS:
        pin = autotune.KernelConfig(1, "bisect", iters)
        got = ops.oga_step_fused(*args, tiling=pin)
        torch.testing.assert_close(got, ref.oga_step_ref(*args, proj="bisect", iters=iters),
                                   atol=BISECT_ATOL, rtol=0)
        torch.testing.assert_close(got, ops.oga_step_fused(*args), atol=BISECT_ATOL, rtol=0)


@pytest.mark.parametrize("N,L", [(777, 10), (203, 100), (37, 1), (91, 30), (9, 512)])
def test_every_legal_row_block_gives_the_same_bits(dev, N, L):
    """Rows per block change the grid only: a row's sums, scans and sort
    run in the same order whatever the block holds. A sortscan row that
    needs no projection beside one that does in a warp, the idle half-warp
    of a lone 16-lane row and the ragged last block (N % row_block != 0)
    carry padding through every shuffle, for both methods (the bisection
    runs on the sortscan layout, and a bisect row that needs no projection
    beside one that does runs on with it). Each method runs every row block
    legal for it."""
    z, a, m, c = _proj_args(_rng(5, N, L), N, L)
    pargs = [torch.from_numpy(t).to(dev) for t in (z, a, m, c)]
    sargs = _step_args(_rng(6, N, L), N, L, dev)
    sargs[-1][::3, 2] = 1e4  # the capacity binds on two rows in three
    runs = {
        "proj_sortscan": ("sortscan", lambda rb: tss.proj_sortscan(*pargs, row_block=rb)),
        "proj_bisect": ("bisect", lambda rb: tpb.proj_bisect(*pargs, row_block=rb)),
        "oga_sortscan": ("sortscan", lambda rb: toga.oga_step_fused(*sargs, row_block=rb)),
        "oga_bisect": ("bisect", lambda rb: toga.oga_step_fused(*sargs, method="bisect",
                                                                row_block=rb)),
    }
    for name, (method, run) in runs.items():
        rbs = [rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L, method)]
        assert rbs[0] == 1 and (L > 16 or len(rbs) == 6)
        base = run(1)
        for rb in rbs[1:]:
            got = run(rb)
            torch.cuda.synchronize()
            assert torch.equal(got, base), f"{name} row_block={rb}"


def test_wrappers_reject_tilings_the_kernels_do_not_take(dev):
    args = _step_args(_rng(7), 8, 10, dev)
    for rb in (3, 64):  # not a power of two; 64 rows of 16 lanes > 512 threads
        with pytest.raises(ValueError):
            toga.oga_step_fused(*args, row_block=rb)
    with pytest.raises(ValueError):
        toga.oga_step_fused(*args, method="quickselect")
    with pytest.raises(ValueError):
        toga.oga_step_fused(*args, method="bisect", iters=autotune.MAX_BISECT_ITERS + 1)
    z = torch.zeros((4, 100), device=dev)
    with pytest.raises(ValueError):  # 32 one-warp bisect rows > 512 threads
        tpb.proj_bisect(z, z, z, torch.zeros(4, device=dev), row_block=32)
    with pytest.raises(ValueError):  # 32 one-warp sortscan rows > 512 threads
        tss.proj_sortscan(z, z, z, torch.zeros(4, device=dev), row_block=32)
    assert tss.proj_sortscan(z, z, z, torch.ones(4, device=dev), row_block=16).shape == (4, 100)


@pytest.mark.parametrize("L", [1, 2, 7, 10, 16, 17, 32, 33, 100, 256])
def test_sortscan_kernels_give_the_network_bits(dev, L):
    """The register network against its float64 numpy emulation
    (tests/_sortscan_network.py), bit for bit, and against the float64
    oracle (1e-6) and the plain version (2e-6: the plain sweep rounds its
    breakpoints to float32); the fused step against its plain version
    (1e-5). Tied breakpoints, masked lanes, a fully masked row, rows that
    bind beside rows that do not in one warp, and an odd row count, at one
    row per block and at the largest legal block."""
    N = 37
    z, a, m, c = net.case_inputs(_rng(13, L), N, L)
    pargs = [torch.from_numpy(t).to(dev) for t in (z, a, m, c)]
    want = net.project(z, a, m, c)
    sargs = _step_args(_rng(14, L), N, L, dev)
    sargs[-1][::2, 2] = 1e4
    big = max(rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L))
    for rb in (1, big):
        got = tss.proj_sortscan(*pargs, row_block=rb).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, ref.proj_rows_exact_np(z, a, m, c), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, ref.proj_rows_sorted(*map(torch.from_numpy, (z, a, m, c))),
                                   atol=2e-6, rtol=0)
        step = toga.oga_step_fused(*sargs, row_block=rb)
        torch.testing.assert_close(step, ref.oga_step_ref(*sargs), atol=1e-5, rtol=0)


@pytest.mark.parametrize("L", [1, 2, 7, 10, 16, 17, 33, 100, 256, 257, 1000, 4096])
def test_proj_bisect_kernel_gives_the_network_bits(dev, L):
    """The bisection's row sums in the kernel's order (lanes in order, then
    the butterfly; a wide row's warps first) against their float32 numpy
    emulation (tests/_bisect_network.py), bit for bit, at one row per block
    and at the largest legal block, 333 rows (a ragged last block; on a few
    rows in a hundred another order of the sums changes the bits); and the
    fused step's bisect branch against its plain version (5e-5). Loose rows
    beside binding ones, masked lanes, a fully masked row, a row of zero
    capacity and a row of z = 0 (both exactly 0)."""
    N = 333
    z, a, m, c = bnet.case_inputs(_rng(18, L), N, L)
    pargs = [torch.from_numpy(t).to(dev) for t in (z, a, m, c)]
    want = bnet.project(z, a, m, c)
    sargs = _step_args(_rng(19, L), N, L, dev)
    sargs[-1][::2, 2] = 1e4
    big = max(rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L, "bisect"))
    for rb in (1, big):
        got = tpb.proj_bisect(*pargs, row_block=rb).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[5] == 0.0).all() and (got[7] == 0.0).all()
        step = toga.oga_step_fused(*sargs, method="bisect", row_block=rb)
        torch.testing.assert_close(step, ref.oga_step_ref(*sargs, proj="bisect"),
                                   atol=BISECT_ATOL, rtol=0)


WIDE_LS = [257, 300, 512, 1000, 4096]


def _wide_proj_args(rng, N, L):
    """``_proj_args`` with rows of zero capacity and rows of z = 0."""
    z, a, m, c = _proj_args(rng, N, L)
    c[1:N:7] = 0.0
    z[2:N:7] = 0.0
    return z, a, m, c


@pytest.mark.parametrize("L", WIDE_LS)
def test_wide_rows_match_oracle_and_plain(dev, L):
    """One block a row: the projection against the float64 oracle on every
    row and the plain version, the fused step against its plain version,
    both bisect kernels against theirs; zero-capacity and all-zero rows
    come back as exact zeros from both sortscan kernels."""
    N = 96
    z, a, m, c = _wide_proj_args(_rng(16, L), N, L)
    pargs = [torch.from_numpy(t).to(dev) for t in (z, a, m, c)]
    assert autotune.row_threads(L) == autotune.WIDE_THREADS
    assert [rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L)] == [1]
    before = tss.proj_sortscan.launches
    got = ops.proj_sortscan(*pargs)
    torch.cuda.synchronize()
    assert tss.proj_sortscan.launches == before + 1
    y = got.cpu().numpy()
    np.testing.assert_allclose(y, ref.proj_rows_exact_np(z, a, m, c), atol=1e-6, rtol=0)
    np.testing.assert_allclose(y, ref.proj_rows_sorted(*map(torch.from_numpy, (z, a, m, c))),
                               atol=2e-6, rtol=0)
    assert (y[1:N:7] == 0.0).all() and (y[2:N:7] == 0.0).all()
    sargs = _step_args(_rng(17, L), N, L, dev)
    sargs[-1][1::7, 2] = 0.0          # zero capacity
    step = ops.oga_step_fused(*sargs)
    # the plain version on CPU copies: on the card its float32 sort and
    # cumsum over 8192 slots lose ~1e-3 at L = 4096 on these rows (the
    # kernel equals the float64 oracle there)
    torch.testing.assert_close(step.cpu(), ref.oga_step_ref(*(t.cpu() for t in sargs)),
                               atol=1e-5, rtol=0)
    assert (step[1::7] == 0.0).all()
    bis = ops.proj_bisect(*pargs)
    torch.testing.assert_close(bis, ref.proj_rows_bisect(*pargs), atol=BISECT_ATOL, rtol=0)
    _feasible(bis.cpu().numpy(), a, m, c)
    pin = autotune.KernelConfig(1, "bisect", autotune.DEFAULT_BISECT_ITERS)
    torch.testing.assert_close(ops.oga_step_fused(*sargs, tiling=pin),
                               ref.oga_step_ref(*sargs, proj="bisect"), atol=BISECT_ATOL, rtol=0)


@pytest.mark.parametrize("N,L,row_block", [(1, 10, 1), (3, 10, 2), (37, 10, 4), (33, 10, 32),
                                           (5, 100, 4), (17, 33, 16)])
def test_sortscan_ragged_last_warp(dev, N, L, row_block):
    """The last block holds fewer rows than row_block (and at L <= 16 its
    last warp may hold one row of two): the launch writes into the first N
    rows of a larger buffer, its padding rows store nothing past them, and
    every row it stores has the emulation's bits."""
    z, a, m, c = net.case_inputs(_rng(15, N, L), N, L)
    pargs = [torch.from_numpy(t).to(dev) for t in (z, a, m, c)]
    buf = torch.full((N + 1, L), -7.0, device=dev)
    _launch.launch("oga_step.cu", "repro_proj_sortscan", pargs, buf[:N], L, row_block,
                   method="sortscan")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(buf[:N].cpu().numpy(), net.project(z, a, m, c))
    assert (buf[N] == -7.0).all()


def test_warmed_dispatch_makes_no_measurement(dev, cache):
    """Once a shape is tuned, dispatch runs off the table: no measurement,
    no miss; and a bisect entry contributes its row block only."""
    cfg = trace.TraceConfig(T=16, L=6, R=16, K=4, seed=2)
    points = sweep.make_grid(cfg, seeds=(2, 3))
    batch = sweep.build_batch(points, device=dev)
    N = batch.size * cfg.R * cfg.K
    autotune._store("oga_step", N, cfg.L, autotune.KernelConfig(4, "bisect", 12), 1.0, {})
    autotune._store("oga_step", cfg.R * cfg.K, cfg.L, autotune.KernelConfig(8, "sortscan", 0),
                    1.0, {})
    autotune.reset_stats()
    slot_graph.reset()
    got = sweep.run_grid(batch, ("ogasched",))["ogasched"]
    single, _ = ogasched.run(batch.spec[0], batch.arrivals[0], eta0=25.0, device=dev)
    stats = autotune.cache_stats()
    assert stats["measurements"] == 0 and stats["misses"] == 0
    # the grid resolves once a slot; the run at each eager slot and once at
    # its capture, and not in a replayed slot
    runs = slot_graph.counts
    assert runs["eager"] + runs["replays"] == cfg.T and runs["captures"] == 1
    assert stats["hits"] == cfg.T + runs["eager"] + runs["captures"]
    pinned, _ = ogasched.run_batch(batch.spec, batch.arrivals, batch.eta0, batch.decay,
                                   tiling=autotune.DEFAULT_CONFIG)
    assert torch.equal(got, pinned)
    torch.testing.assert_close(single, got[0], atol=1e-4 * float(single.abs().max()), rtol=0)


def test_tune_times_every_candidate_on_the_card(dev, cache):
    cands = autotune.candidates("proj", 256, 10, methods=autotune.PROJ_METHODS)
    win, measured = autotune.tune("proj", 256, 10, methods=autotune.PROJ_METHODS,
                                  repeats=3, store=False)
    assert win in cands and len(measured) == len(cands)
    assert all(0 < us < 1e5 for us in measured.values())
    assert autotune.measurement_count() == len(cands)
    assert autotune.lookup("proj", 256, 10) is None
    win, _ = autotune.tune("oga_step", 768, 10, repeats=3)
    assert autotune.resolve("oga_step", 768, 10) == win


def test_proj_bisect_kernel_takes_bf16(dev):
    z, a, m, c = _proj_args(_rng(8), 768, 10)
    args = [torch.from_numpy(t).to(dev, torch.bfloat16) for t in (z, a, m, c)]
    got = ops.proj_bisect(*args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.proj_rows_bisect(*args).float(),
                               atol=2 ** -5, rtol=0)
    with pytest.raises(TypeError):
        ops.proj_bisect(args[0], *(t.float() for t in args[1:]))


def _qkv(rng, B, S, H, G, hd, dev, dtype):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
            for s in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd))]


@pytest.mark.parametrize("B,S,H,G,hd,window,softcap", [
    (1, 128, 4, 2, 64, None, None), (2, 256, 4, 1, 64, None, None),
    (1, 256, 8, 8, 128, None, None), (2, 512, 2, 1, 64, None, None),
    (1, 256, 4, 2, 80, None, None), (1, 256, 4, 2, 64, 128, None),
    (1, 256, 4, 2, 64, None, 30.0), (1, 256, 4, 2, 64, 128, 50.0),
    (1, 191, 4, 2, 128, 64, 50.0), (3, 77, 6, 3, 80, 0, None),
    (1, 128, 4, 2, 16, None, None), (1, 200, 4, 2, 16, 16, 50.0),
    (2, 96, 8, 1, 32, None, 30.0), (1, 256, 6, 3, 48, None, None),
    (1, 177, 4, 2, 48, 64, 50.0), (1, 130, 6, 2, 96, 100, None),
    (1, 256, 8, 1, 112, None, None), (2, 150, 16, 2, 112, 64, 50.0),
    (1, 1200, 25, 5, 64, 1024, None), (2, 200, 25, 5, 64, 100, 50.0),
    (1, 300, 28, 4, 128, None, None), (1, 256, 24, 24, 64, None, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, B, S, H, G, hd, window, softcap, dtype):
    q, k, v = _qkv(_rng(9, S, hd), B, S, H, G, hd, dev, dtype)
    before = tfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1 and got.dtype == dtype
    _assert_flash_close(got, q, k, v, window, softcap)


def _assert_flash_close(got, q, k, v, window, softcap):
    """The kernel's output against the plain version: 2e-5 in float32; in
    bf16 min(0.05, 1e-4 + 2^-6 |o| + 2^-8 |o|_abs) elementwise."""
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        return
    want_abs = ref.flash_attention_ref(q, k, v.abs(), window=window, softcap=softcap).float()
    want = want.float()
    bar = (1e-4 + 2 ** -6 * want.abs() + 2 ** -8 * want_abs).clamp(max=0.05)
    diff = (got.float() - want).abs()
    worst = float((diff / bar).max())
    assert worst <= 1.0, f"max |diff| {float(diff.max())}, {worst} times its bar"


@pytest.mark.parametrize("B,S,H,G,hd,window,softcap", [
    (3, 1, 8, 1, 64, None, 50.0), (2, 127, 4, 2, 128, None, None),
    (1, 128, 4, 4, 128, None, 50.0), (2, 129, 16, 2, 128, None, None),
    (1, 300, 4, 2, 64, 16, 50.0), (2, 200, 4, 1, 128, 16, None),
    (1, 150, 4, 2, 80, 1000, None), (2, 256, 8, 1, 128, 100, 50.0),
    (1, 8191, 4, 2, 80, 4096, 50.0), (1, 8191, 2, 1, 80, None, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_edges(dev, B, S, H, G, hd, window, softcap, dtype):
    """The tile edges of both kernels: S = 1, S at and around one 128-row
    tile, a window narrower than a K tile and one wider than S, rep 1, 2
    and 8 with B > 1, and hd 80 (run as 128 by the bf16 kernel) at a
    ragged 8191."""
    q, k, v = _qkv(_rng(11, S, hd, H), B, S, H, G, hd, dev, dtype)
    before = dict(tfa.flash_attention.kernel_launches)
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    name = "bf16" if dtype == torch.bfloat16 else "float32"
    assert tfa.flash_attention.kernel_launches[name] == before[name] + 1
    _assert_flash_close(got, q, k, v, window, softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_softcap_on_large_scores(dev, dtype):
    """Scores far past the softcap: heads 0 and 2 get q scaled by 40, so
    |s| scale / softcap reaches ~3 and tanh saturates; the bf16 kernel's
    warps there take tanhf's ex2 branch, those of heads 1 and 3 its
    polynomial alone, in one launch."""
    q, k, v = _qkv(_rng(12), 2, 300, 4, 2, 128, dev, dtype)
    q[:, :, ::2] *= 40.0
    got = ops.flash_attention(q, k, v, window=100, softcap=50.0)
    torch.cuda.synchronize()
    _assert_flash_close(got, q, k, v, 100, 50.0)


def test_flash_kernel_reads_strided_views(dev):
    """q, k, v as views of one fused (B, S, H + 2G, hd) tensor: read through
    their strides, nothing copied."""
    B, S, H, G, hd = 2, 200, 4, 2, 128
    qkv = torch.randn(B, S, H + 2 * G, hd, device=dev)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + G], qkv[:, :, H + G:]
    got = ops.flash_attention(q, k, v, window=64, softcap=50.0)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                                   window=64, softcap=50.0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :24], k[..., :24], v[..., :24])


def test_flash_bf16_kernel_reads_strided_views(dev):
    """The same fused-qkv views in bf16: the tensor-core kernel's tensor
    maps read them through their byte strides."""
    B, S, H, G, hd = 2, 200, 4, 2, 128
    qkv = torch.randn(B, S, H + 2 * G, hd, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + G], qkv[:, :, H + G:]
    got = ops.flash_attention(q, k, v, window=64, softcap=50.0)
    _assert_flash_close(got, q.contiguous(), k.contiguous(), v.contiguous(), 64, 50.0)


def test_flash_bf16_kernel_refuses_what_tma_cannot_read(dev):
    """A bf16 view whose base sits 8 bytes off a 16-byte boundary raises
    before any launch; the float32 kernel, which reads no tensor maps,
    takes the same misalignment."""
    B, S, H, G, hd = 1, 64, 2, 1, 64
    n = B * S * H * hd
    for dtype, off in ((torch.bfloat16, 4), (torch.float32, 2)):
        buf = torch.randn(n + 8, device=dev).to(dtype)
        q = buf[off:off + n].view(B, S, H, hd)
        k, v = (torch.randn(B, S, G, hd, device=dev).to(dtype) for _ in range(2))
        assert q.data_ptr() % 16 == 8
        before = tfa.flash_attention.launches
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="multiple of 16"):
                ops.flash_attention(q, k, v)
            assert tfa.flash_attention.launches == before
        else:
            _assert_flash_close(ops.flash_attention(q, k, v), q, k, v, None, None)


@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-3b"])
def test_lm_prefill_on_the_card_matches_cpu(dev, arch):
    """A reduced config widened to a head dim the kernel takes: prefill on
    the card (one kernel launch per layer) against the plain CPU path."""
    cfg = tconfigs.reduced(tconfigs.get(arch), head_dim=64, n_layers=3)
    params = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(_rng(10).integers(0, cfg.vocab, (2, 96)))
    want, wcache = TM.prefill(params, cfg, {"tokens": toks})
    on_card = _to(params, dev)
    before = tfa.flash_attention.launches
    got, gcache = TM.prefill(on_card, cfg, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)
    torch.testing.assert_close(gcache["k"].cpu(), wcache["k"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-3b"])
def test_reduced_config_prefill_on_the_card_matches_cpu(dev, arch):
    """A reduced config as it is (float32, head dim 16; gemma's with a
    window of 16 and a softcap): prefill on the card, through the float32
    kernel once per layer, against the same call on the CPU, at the CPU
    tests' bar of 1e-4 on the logits."""
    cfg = tconfigs.reduced(tconfigs.get(arch))
    params = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(_rng(13).integers(0, cfg.vocab, (2, 96)))
    want, wcache = TM.prefill(params, cfg, {"tokens": toks})
    before = tfa.flash_attention.kernel_launches["float32"]
    got, gcache = TM.prefill(_to(params, dev), cfg, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert tfa.flash_attention.kernel_launches["float32"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    torch.testing.assert_close(gcache["k"].cpu(), wcache["k"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b",
                                  "qwen2-vl-7b", "musicgen-medium"])
def test_reduced_family_prefill_and_decode_on_the_card_match_cpu(dev, arch):
    """The other families' reduced configs (float32; vlm with its 8 patch
    embeddings): prefill of 2 x 96 tokens, through the float32 kernel once
    per attention layer, and 8 decode steps after it, on the card against
    the CPU at 1e-4 on the logits; the caches (K/V, the SSM's conv window
    and state) within 1e-4 of their largest magnitude."""
    cfg = tconfigs.reduced(tconfigs.get(arch))
    params = TM.init_params(cfg, 0, "cpu")
    rng = _rng(14)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96)))
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.n_patches, TM.PATCH_DIM)).astype(np.float32))
    S = 96 + (cfg.n_patches if cfg.family == "vlm" else 0)

    def run(p, b, d):
        logits, cache = TM.prefill(p, cfg, b)
        cache = {k: v if k in ttf.SSM_CACHE else torch.cat(
            [v, torch.full_like(v[:, :, :8], ttf.EMPTY_KPOS if k == "kpos" else 0)], dim=2)
            for k, v in cache.items()}
        steps = []
        for i in range(8):
            lg, cache = TM.serve_step(p, cfg, cache, b["tokens"][:, i:i + 1], S + i)
            steps.append(lg)
        return logits, torch.stack(steps), cache

    want = run(params, batch, "cpu")
    before = tfa.flash_attention.kernel_launches["float32"]
    got = run(_to(params, dev), _to(batch, dev), dev)
    torch.cuda.synchronize()
    assert tfa.flash_attention.kernel_launches["float32"] == before + (
        cfg.n_layers if cfg.has_attn else 0)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], atol=1e-4, rtol=0)
    for name, t in want[2].items():
        scale = max(float(t.float().abs().max()), 1.0)
        torch.testing.assert_close(got[2][name].cpu(), t, atol=1e-4 * scale, rtol=0)


def _to(tree, dev):
    """A tree of dicts and lists of tensors (a model's parameters, a
    batch) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("name", ["ogasched", "fairness", "hesrpt"])
def test_lifecycle_with_faults_on_the_card_matches_cpu(dev, name):
    """50 slots of the faulted lifecycle: every allocation is one
    proj_sortscan launch (24 a slot inside heSRPT), OGASCHED's update one
    fused launch, and the card's events equal the CPU's."""
    cfg = trace.TraceConfig(T=50, L=6, R=16, K=4, seed=0, work_mean=40.0,
                            faults=trace.FaultConfig(fail_rate=0.05, fail_frac=0.5,
                                                     repair_mean=10.0))
    spec, arr, works = trace.make_lifecycle(cfg, device="cpu")
    faults = trace.build_faults(cfg, device="cpu")
    f0, p0 = toga.oga_step_fused.launches, tss.proj_sortscan.launches
    got = lifecycle.run(spec, arr, works, name, faults=faults, device=dev)
    torch.cuda.synchronize()
    fused, proj = toga.oga_step_fused.launches - f0, tss.proj_sortscan.launches - p0
    assert (fused, proj) == {"ogasched": (50, 50), "fairness": (0, 50), "hesrpt": (0, 24 * 50)}[name]
    want = lifecycle.run(spec, arr, works, name, faults=faults, device="cpu")
    for f in ("admitted", "departed", "evicted", "running", "q_depth", "rdropped"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("rewards", "used", "work_done", "jct"):
        w = getattr(want, f)
        torch.testing.assert_close(getattr(got, f).cpu(), w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    c_t = spec.c[None] * faults[:, None, :]
    assert (got.used.cpu() <= c_t * (1 + lifecycle.FEAS_TOL) + lifecycle.FEAS_TOL).all()


# ------------------------------------------------------------ stream path --
def test_device_traces_on_the_card_match_cpu(dev):
    """The hash words and the spec are the CPU's bit for bit (integer and
    correctly rounded float32 arithmetic); arrivals may flip where sin
    rounds otherwise (<= 1e-3 of them), job sizes within 1e-5 (pow)."""
    from repro_torch.sched import trace_device

    cfgs = [trace.TraceConfig(T=100, L=6, R=16, K=4, seed=s) for s in (0, 1, 2 ** 32 - 1)]
    seeds = [c.seed for c in cfgs]
    for stream in trace.STREAMS:
        got = trace_device.stream_bits(torch.tensor(seeds, device=dev), stream, (64, 600))
        want = trace_device.stream_bits(torch.tensor(seeds), stream, (64, 600))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), stream
    card = trace_device.make_batch(cfgs, with_works=True, device=dev)
    host = trace_device.make_batch(cfgs, with_works=True, device="cpu")
    for f in card[0].FIELDS:
        assert torch.equal(getattr(card[0], f).cpu(), getattr(host[0], f)), f
    assert float((card[1].cpu() != host[1]).float().mean()) <= 1e-3
    torch.testing.assert_close(card[2].cpu(), host[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["slot", "lifecycle"])
def test_stream_matches_resident_on_the_card(dev, mode):
    """5 configs in chunks of 2 (the last padded) against one resident
    batch of the 5 on the card: the rows of every algorithm within 1e-6 of
    their largest (the kernels' rows are independent of the batch; torch's
    reductions may group a batch of 2 otherwise than one of 5)."""
    points = sweep.make_grid(trace.TraceConfig(T=40, L=6, R=16, K=4), seeds=range(5))
    algos = ("ogasched", "fairness")
    resident = sweep.run_grid(sweep.build_batch(points, mode=mode, device=dev), algos,
                              mode=mode)
    for sl, _, out in sweep.run_grid_stream(points, algos, chunk_size=2, mode=mode, device=dev):
        for name in algos:
            got, want = out[name], resident[name][sl]
            if mode == "lifecycle":
                for f in ("admitted", "departed", "q_depth"):
                    assert torch.equal(getattr(got, f), getattr(want, f)), (name, f)
                got, want = got.rewards, want.rewards
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-6 * max(1.0, float(want.abs().max())))


def test_offline_optimum_batch_on_the_card_matches_single_configs(dev):
    """One proj_sortscan launch an iteration over all G*R*K rows; each row
    within 1e-6 of its config's own oracle on the card (bit for bit on the
    CPU, tests/test_torch_regret_stream.py)."""
    from repro_torch.core import regret

    points = sweep.make_grid(trace.TraceConfig(T=80, L=6, R=16, K=4, utility="log"),
                             seeds=range(3))
    batch = sweep.build_batch(points, device=dev)
    p0 = tss.proj_sortscan.launches
    y = regret.offline_optimum_batch(batch.spec, batch.arrivals, iters=200, device=dev)
    torch.cuda.synchronize()
    assert tss.proj_sortscan.launches - p0 == 200
    for g in range(3):
        single = regret.offline_optimum(batch.spec[g], batch.arrivals[g], iters=200, device=dev)
        torch.testing.assert_close(y[g], single, rtol=0,
                                   atol=1e-6 * max(1.0, float(single.abs().max())))


# ------------------------------------------------ the extensions path ------
@pytest.mark.parametrize("N,L", [(768, 90), (768, 40), (384, 4), (196608, 100), (786432, 100)])
def test_fused_kernel_at_the_extension_shapes(dev, N, L):
    """The fused step at the packed shapes of §3.4 (J = 9), §3.5 (Q = 4),
    the job manager and §3.2 on 4 and 1 shards, against its plain version
    at 1e-5 (the plain version over blocks of rows, as chip_smoke.py runs
    it there), at one row per block and at every legal row block bit for
    bit."""
    import chip_smoke

    args = _step_args(_rng(7, N, L), N, L, dev)
    got = toga.oga_step_fused(*args, row_block=1)
    torch.testing.assert_close(got, chip_smoke.plain_rows(ref.oga_step_ref, args), rtol=0,
                               atol=1e-5)
    for cand in autotune.candidates("oga_step", N, L)[1:]:
        assert torch.equal(toga.oga_step_fused(*args, row_block=cand.row_block), got)


def test_sharded_step_on_the_card(dev):
    """The §3.2 step on 1 and 4 shards of the card against the unsharded
    fused step: y bit for bit on one shard, within 2e-5 on four (the
    reference's bar); q within 1e-5 relative; one launch a shard."""
    from repro_torch.core import distributed, graph

    spec = trace.build_spec(trace.TraceConfig(L=20, R=4096, K=6, seed=0, density=0.25), dev)
    y = graph.random_feasible_decision(spec, np.random.default_rng(0))
    x = (torch.from_numpy(np.random.default_rng(1).random(20)) < 0.7).to(torch.float32).to(dev)
    eta = torch.tensor(25.0, device=dev)
    state, q_ref = ogasched.oga_step(spec, ogasched.OGAState(y=y, eta=eta, t=0), x, 1.0,
                                     backend="auto")
    for n in (1, 4):
        mesh = [dev] * n
        n0 = toga.oga_step_fused.launches
        y_sh, q = distributed.make_distributed_step(spec, mesh)(distributed.shard_y(y, mesh),
                                                                x, eta)
        torch.cuda.synchronize()
        assert toga.oga_step_fused.launches - n0 == n
        got = distributed.gather_y(y_sh)
        if n == 1:
            assert torch.equal(got, state.y)
        torch.testing.assert_close(got, state.y, rtol=0, atol=2e-5)
        assert abs(float(q) - float(q_ref)) <= 1e-5 * abs(float(q_ref))


def test_gang_steps_on_the_card_match_cpu(dev):
    """40 §3.5 gang steps at chip_smoke.py's setup on the card and on the
    CPU: the same kept-port mask every slot, Σ q within 1e-5 relative."""
    import chip_smoke
    from repro_torch.core import extensions

    def run(device):
        spec, arr = trace.make(trace.TraceConfig(**chip_smoke.EXT_MULTI_CFG), device=device)
        req = chip_smoke.gang_task_requests(spec.L, spec.K)
        espec, pot, _ = extensions.expand_gang(spec, req)
        m_min = torch.from_numpy(chip_smoke.gang_m_min(req)).to(device)
        y = torch.zeros((espec.L, espec.R, espec.K), device=device)
        kept, qs = [], []
        for t in range(40):
            y, q = extensions.gang_oga_step(espec, arr[t], y, torch.tensor(5.0, device=device),
                                            pot, m_min, spec.L)
            kept.append(extensions.kept_ports(y, pot, m_min, spec.L).cpu())
            qs.append(float(q))
        return torch.stack(kept), np.sum(qs)

    got_kept, got_q = run(dev)
    want_kept, want_q = run("cpu")
    assert torch.equal(got_kept, want_kept)
    assert abs(got_q - want_q) <= 1e-5 * abs(want_q)


def test_int8_cache_on_the_card_matches_cpu(dev):
    """reduced(stablelm-3b) with the int8 KV cache, prefilled and decoded on
    the card and on the CPU (chip_smoke.py's reduced_lm check): prefill
    logits within 1e-4, int8 codes within one step, the decode within
    1e-4 plus INT8_FLIP_LOGIT for each code that differs."""
    import chip_smoke
    from repro_torch.models import transformer as ttf

    cfg = tconfigs.reduced(tconfigs.get("stablelm-3b"), kv_cache_quant=True)
    params = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)))
    want = chip_smoke.prefill_then_decode(torch, TM, ttf, params, cfg, {"tokens": toks}, 6)
    got = chip_smoke.prefill_then_decode(torch, TM, ttf, chip_smoke.to_device(params, dev), cfg,
                                         {"tokens": toks.to(dev)}, 6)
    r = chip_smoke.int8_card_vs_cpu(torch, got, want)
    assert r["finite"] and r["prefill_max_abs_dlogit"] <= 1e-4 and r["max_abs_dcode"] <= 1
    assert r["decode_max_abs_dlogit"] <= 1e-4 + chip_smoke.INT8_FLIP_LOGIT * r["codes_differing"]


# The flash backward kernels: float32 each of dq, dk, dv within 1e-4 of its
# largest magnitude of the plain version; bf16 the kernel's distance from
# the emulation of its arithmetic (ref.flash_attention_bwd_emulation: the
# tensor-core kernels round P and dS to bf16 before their products) at most
# two bf16 ulps of the float32 gradient's largest magnitude (chip_smoke.py's
# bars: the two differ by the order of float32 sums, so by roundings that
# flip; the emulation itself can leave the older bar around the float32
# gradient at small shapes, tests/test_torch_flash_bwd_numerics.py); two
# launches bit for bit.
# The bf16 cases include the path shapes' small cousins: hd 80 (stablelm-3b)
# and 128 (gemma2-27b), with a window and a softcap. The float32 kernels'
# design boundaries: hd 128 at rep 2 with a window (one ring stage), hd 96
# (the widest with two) at rep 7 (the dQ kernel packs 18 positions of 7
# heads), and S not a multiple of the 128-row blocks or the 64-row tiles
# (S = 3 too: at S = 1 a query's one key gives dS = P (dP - D) = 0 exactly,
# so dq and dk are rounding residue and a bar of 1e-4 of their max reads
# that residue against itself).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,softcap", [
    ((2, 96, 4, 2, 16), 0, None), ((1, 256, 4, 1, 16), 16, 50.0), ((1, 1000, 8, 2, 64), 0, None),
    ((2, 512, 8, 8, 80), 0, None), ((1, 300, 4, 2, 80), 64, 50.0),
    ((1, 640, 8, 4, 128), 256, 50.0), ((1, 257, 7, 1, 112), None, None),
    ((2, 200, 4, 2, 128), 100, None), ((1, 190, 14, 2, 96), 65, 30.0),
    ((2, 3, 4, 2, 48), None, None),
])
def test_flash_bwd_kernel_matches_plain(dev, shape, window, softcap, dtype):
    B, S, H, G, hd = shape
    rng = _rng(30, S, H)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
                   for s in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd), (B, S, H, hd)))
    o, lse = ops.flash_attention(q, k, v, window=window, softcap=softcap, return_lse=True)
    before = tfa.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, window=window, softcap=softcap)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window, softcap=softcap)
    f32 = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                      window=window, softcap=softcap)
    emu = (ref.flash_attention_bwd_emulation(q, k, v, o, lse, do, window=window,
                                             softcap=softcap)
           if dtype == torch.bfloat16 else None)
    for i, (g, p, w) in enumerate(zip(got, plain, f32)):
        assert g.dtype == dtype and g.shape == p.shape
        mx = float(w.abs().max())
        if dtype == torch.float32:
            assert float((g - p).abs().max()) <= 1e-4 * mx
        else:
            ulp = 2.0 ** (math.floor(math.log2(mx)) - 7)
            assert float((g.float() - emu[i].float()).abs().max()) <= 2 * ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,softcap", [
    ((2, 300, 8, 8, 80), None, None), ((1, 333, 8, 4, 128), 128, 50.0),
    ((1, 129, 25, 5, 64), 100, None), ((3, 1, 8, 1, 16), None, 50.0),
])
def test_flash_forward_lse_keeps_o_bits_and_matches_plain(dev, shape, window, softcap, dtype):
    """One launch with the lse written and one without give o bit for bit;
    the lse is the plain version's within 1e-5 relative (1e-5 absolute
    below 1): the kernels' scores sum in another order, and in bf16 the
    inputs are exact while P's rounding does not reach l."""
    B, S, H, G, hd = shape
    q, k, v = _qkv(_rng(32, S, hd), B, S, H, G, hd, dev, dtype)
    before = tfa.flash_attention.launches
    o = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    o2, lse = ops.flash_attention(q, k, v, window=window, softcap=softcap, return_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 2
    assert torch.equal(o, o2) and lse.dtype == torch.float32 and lse.shape == (B, H, S)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=softcap, return_lse=True)[1]
    assert float(((lse - want).abs() / want.abs().clamp_min(1.0)).max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_bf16_refuses_what_tma_cannot_read(dev, dtype):
    """The backward reads q, k, v and dO through tensor maps in either
    dtype: a dO whose base sits 8 bytes off a 16-byte boundary raises
    before any launch."""
    B, S, H, G, hd = 1, 64, 2, 1, 64
    q, k, v = _qkv(_rng(33), B, S, H, G, hd, dev, dtype)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    n = B * S * H * hd
    off = 8 // torch.empty((), dtype=dtype).element_size()
    do = torch.randn(n + 8, device=dev).to(dtype)[off:off + n].view(B, S, H, hd)
    assert do.data_ptr() % 16 == 8
    before = tfa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert tfa.flash_attention_bwd.launches == before


def test_reduced_train_step_on_the_card_matches_cpu(dev):
    """One loss and gradient of reduced(gemma2-27b) (window, softcaps,
    float32, head dim 16) on the card, through both flash kernels, against
    the CPU: the loss within 1e-5 relative, every gradient leaf within 1e-4
    of its largest magnitude."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.train_step import value_and_grad

    cfg = tconfigs.reduced(tconfigs.get("gemma2-27b"))
    params = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(_rng(31).integers(0, cfg.vocab, (2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want_loss, want = value_and_grad(params, cfg, batch)
    before = tfa.flash_attention_bwd.kernel_launches["float32"]
    got_loss, got = value_and_grad(_to(params, dev), cfg, _to(batch, dev))
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.kernel_launches["float32"] == (
        before + len(tfa.BWD_KERNELS["float32"]) * cfg.n_layers)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_pipeline_on_the_card_matches_cpu(dev):
    """The GPipe pipeline of reduced(stablelm-3b) at 8 layers on 4 stages
    of the card (float32, head dim 16): the output bit for bit the card's
    ``stack_forward`` over the same two microbatches and within 1e-4 of
    the CPU's pipeline, every gradient leaf within 1e-4 of its largest
    magnitude of the CPU's; one forward and one backward flash call per
    layer and microbatch."""
    from repro_torch.models import pipeline as tpp
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.meshctx import make_mesh

    cfg = tconfigs.reduced(tconfigs.get("stablelm-3b"), n_layers=8)
    params = TM.init_params(cfg, 0, "cpu")
    x = torch.from_numpy(_rng(41).standard_normal((4, 32, cfg.d_model)).astype(np.float32))
    pos = torch.arange(32).expand(4, 32)

    def run(blocks, xx, p, devs):
        for t in tree_leaves(blocks):
            t.requires_grad_()
        out = tpp.pipeline_forward(blocks, cfg, xx, p, make_mesh((4,), ("model",), devs), 2)
        (out ** 2).sum().backward()
        return out.detach(), [t.grad for t in tree_leaves(blocks)]

    blocks = _to(params["blocks"], dev)
    want, want_g = run(params["blocks"], x, pos, ["cpu"] * 4)
    fwd0, bwd0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    got, got_g = run(blocks, x.to(dev), pos.to(dev), [dev] * 4)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - fwd0 == 16
    assert tfa.flash_attention_bwd.launches - bwd0 == 16
    with torch.no_grad():
        micro = torch.cat([ttf.stack_forward(blocks, cfg, xm, pos[:2].to(dev))
                           for xm in x.to(dev).split(2)])
    assert torch.equal(got, micro)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    for g, w in zip(got_g, want_g):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_ep_on_the_card_matches_cpu(dev, cf):
    """``apply_moe_ep`` on a (data 2, model 4) mesh of the card against the
    same on ``["cpu"] * 8``: the kept (token, expert) pairs equal, the
    output within 1e-5 of its largest magnitude; ``apply_mlp_ep`` likewise."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.layers import swiglu_init
    from repro_torch.train.meshctx import make_mesh

    cfg = tconfigs.ArchConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                              n_kv=2, d_ff=0, vocab=64, n_experts=8, top_k=2, d_expert=16,
                              n_shared_experts=1, capacity_factor=cf, param_dtype="float32",
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, 32, 16, 8, 1, torch.float32)
    x = torch.from_numpy(_rng(42).standard_normal((4, 64, 32)).astype(np.float32))
    cpu, card = (make_mesh((2, 4), ("data", "model"), [d] * 8) for d in ("cpu", dev))
    want, want_kept = tmoe.apply_moe_ep(p, x, cfg, cpu, return_kept=True)
    got, got_kept = tmoe.apply_moe_ep(_to(p, dev), x.to(dev), cfg, card, return_kept=True)
    assert torch.equal(got_kept.cpu(), want_kept)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    mlp = swiglu_init(gen, 32, 64, torch.float32)
    want = tmoe.apply_mlp_ep(mlp, x, None, cpu)
    got = tmoe.apply_mlp_ep(_to(mlp, dev), x.to(dev), None, card)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------------------------- sanitizers --
def test_sync_guard_raises_on_a_host_read_of_a_cuda_tensor(dev):
    from repro_torch import compat

    t = torch.ones(4, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    with compat.sync_guard("error"):
        with pytest.raises(RuntimeError):
            t.sum().item()
        with pytest.raises(RuntimeError):
            t[t > 0]
        (t * 2).sum()                       # stays on the card: no error
    assert torch.cuda.get_sync_debug_mode() == before
    float(t.sum())                          # the mode is restored


@pytest.mark.torch_sanitized
@pytest.mark.parametrize("path", ["path_reward_grad", "path_projection_fill", "path_oga_run",
                                  "path_regret_curve"])
def test_sanitized_paths_run_clean_on_the_card(dev, path):
    """The four paths of tests/test_torch_sanitizers.py on the card under
    ``sync_guard("error")``, their results read back after it and held to
    the same paths on the CPU (the card's projection solves in double,
    the CPU's in float32: 1e-4 of each result's largest magnitude)."""
    import test_torch_sanitizers as san

    card, cpu = san.stage_all(dev), san.stage_all("cpu")
    torch.cuda.synchronize()
    with san.guards():
        got = getattr(san, path)(card)
    want = getattr(san, path)(cpu)
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple)
                                                            else (want,))
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, path


def test_warm_build_compiles_nothing(dev):
    from repro_torch import compat
    from repro_torch.kernels import build

    build.build()
    with compat.CompilationCounter() as c:
        assert build.build() == {}
    assert c.supported and c.count == 0


def test_tune_compiles_nothing_during_its_trials(dev, cache):
    from repro_torch import compat

    ops.oga_step_fused(*_step_args(_rng(11), 768, 10, dev))   # the libraries loaded
    with compat.CompilationCounter() as c:
        win, measured = autotune.tune("oga_step", 768, 10, repeats=3, store=False)
    assert len(measured) > 1 and c.supported and c.count == 0


def test_flash_meta_branch_returns_the_kernels_shapes(dev):
    """Meta tensors get the kernels' output shapes and dtypes with nothing
    launched; the card's path on the same shapes still launches."""
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(2, 128, 8, 64, device=dev, dtype=dt)
        k, v = (torch.randn(2, 128, 2, 64, device=dev, dtype=dt) for _ in range(2))
        qm, km, vm = (t.to("meta") for t in (q, k, v))
        n0, b0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
        o_m, lse_m = tfa.flash_attention(qm, km, vm, window=64, return_lse=True)
        dq, dk, dv = tfa.flash_attention_bwd(qm, km, vm, o_m, lse_m, o_m, window=64)
        assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == (n0, b0)
        o, lse = tfa.flash_attention(q, k, v, window=64, return_lse=True)
        g = tfa.flash_attention_bwd(q, k, v, o, lse, o, window=64)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == n0 + 1
        assert tfa.flash_attention_bwd.launches == b0 + 1
        for m, c in ((o_m, o), (lse_m, lse), (dq, g[0]), (dk, g[1]), (dv, g[2])):
            assert m.device.type == "meta"
            assert (m.shape, m.dtype, m.stride()) == (c.shape, c.dtype, c.stride())


# ------------------------------------------------- the slot's CUDA graph --
# (L, R, K): the trace and the learning rate of fig5's cluster (chip_smoke's
# fig5 phase at the benchmark's contention) and of Fig. 2's
SLOT_GRAPH_CASES = {
    (100, 1024, 6): (dict(contention=5.0, rho=0.95, beta_range=(0.01, 0.015)), 2.0, 0.9995),
    (10, 128, 6): (dict(contention=10.0), 25.0, 0.9999),
}


@pytest.fixture
def graphs():
    slot_graph.reset()
    yield slot_graph
    slot_graph.reset()


def _slot_problem(shape, T, dev):
    (L, R, K), (kw, eta0, decay) = shape, SLOT_GRAPH_CASES[shape]
    spec, arr = trace.make(trace.TraceConfig(T=T, L=L, R=R, K=K, seed=7, **kw), device=dev)
    return spec, arr, ops.pack_spec_operands(spec), eta0, decay


@pytest.mark.parametrize("shape", list(SLOT_GRAPH_CASES))
def test_replayed_slots_equal_the_eager_slots_bit_for_bit(dev, graphs, shape):
    """200 slots of ``oga_step`` (captured at slot 2, replayed after) against
    the eager slot: every y(t+1), q_t and eta bit for bit and in the same
    layout, read after all 200 slots, so every returned y still holds its
    slot's values; the fused kernel's launches by shape equal the eager
    slots', one a slot."""
    T = 200
    spec, arr, operands, eta0, decay = _slot_problem(shape, T, dev)
    rows = (spec.R * spec.K, spec.L)
    by_shape = toga.oga_step_fused.launches_by_shape
    n0 = by_shape[rows]
    state = ogasched.init_state(spec, eta0)
    ys, qs = [], []
    for t in range(T):
        state, q = ogasched.oga_step(spec, state, arr[t], decay, "fused", operands)
        ys.append(state.y)
        qs.append(q)
    n1 = by_shape[rows]
    assert graphs.counts == {"eager": 2, "captures": 1, "replays": T - 2}
    y, eta = ogasched.init_state(spec, eta0).y, ogasched.init_state(spec, eta0).eta
    for t in range(T):
        y, q, eta = ogasched._slot(spec, y, arr[t], eta, decay, "fused", operands)
        assert ys[t].stride() == y.stride() and torch.equal(ys[t], y), f"y at slot {t}"
        assert torch.equal(qs[t], q), f"q at slot {t}"
    assert torch.equal(state.eta, eta)
    assert n1 - n0 == by_shape[rows] - n1 == T


def test_a_new_spec_operands_or_decay_recaptures(dev, graphs):
    """Each of a new spec, a new operands tuple and a new decay runs its
    first slot eagerly and is captured on its second; one graph stays."""
    spec, arr, operands, eta0, decay = _slot_problem((10, 128, 6), 20, dev)
    state = ogasched.init_state(spec, eta0)
    t = 0

    def slots(n, spec, operands, decay):
        nonlocal state, t
        for _ in range(n):
            state, _ = ogasched.oga_step(spec, state, arr[t], decay, "fused", operands)
            t += 1

    slots(3, spec, operands, decay)
    assert graphs.counts == {"eager": 2, "captures": 1, "replays": 1}
    new_spec = dataclasses.replace(spec, c=spec.c.clone())
    for args in ((spec, ops.pack_spec_operands(spec), decay), (new_spec, operands, decay),
                 (spec, operands, 0.999)):
        before = dict(graphs.counts)
        slots(2, *args)
        assert graphs.counts["eager"] == before["eager"] + 1
        assert graphs.counts["captures"] == before["captures"] + 1
        assert graphs.counts["replays"] == before["replays"] + 1
    assert len(graphs._graphs) == 1
    slots(3, spec, operands, 0.999)
    assert graphs.counts["replays"] == 7 and graphs.counts["captures"] == 4


def test_a_clusters_graph_goes_with_the_cluster(dev, graphs):
    """``ogasched.run`` captures its cluster's slot; once the run has
    returned and its operands are freed, the graph and its memory pool are
    gone, and the card holds what it held before."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    spec, arr, operands, eta0, decay = _slot_problem((100, 1024, 6), 8, dev)
    del operands
    rewards, y = ogasched.run(spec, arr, eta0, decay, device=dev)
    assert graphs.counts["captures"] == 1 and graphs._graphs == {}
    del spec, arr, rewards, y
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) < before + 2**20


def test_the_profiler_sees_the_fused_kernel_inside_a_replay(dev, graphs):
    """Under ``torch.profiler``, five replayed slots show five
    ``oga_step_sortscan_kernel`` launches with device time, and five
    ``repro_torch.oga_step.replay`` spans and none of the eager slot's."""
    spec, arr, operands, eta0, decay = _slot_problem((10, 128, 6), 8, dev)
    state = ogasched.init_state(spec, eta0)
    for t in range(3):
        state, _ = ogasched.oga_step(spec, state, arr[t], decay, "fused", operands)
    torch.cuda.synchronize()
    spans.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(3, 8):
            state, _ = ogasched.oga_step(spec, state, arr[t], decay, "fused", operands)
        torch.cuda.synchronize()
    snap = spans.snapshot()
    spans.reset()
    assert snap[slot_graph.REPLAY_SPAN][0] == snap[ogasched.STEP_SPAN][0] == 5
    assert "repro_torch.reward" not in snap and "repro_torch.launch" not in snap
    kernels = [e for e in prof.key_averages() if "oga_step_sortscan_kernel" in e.key]
    assert sum(e.count for e in kernels) == 5
    assert sum(float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0)) for e in kernels) > 0
