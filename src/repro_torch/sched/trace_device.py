"""Trace synthesis on the device: a whole chunk of configurations at once.

Counterpart of ``repro.sched.trace_device``. The streamed sweep
(``sweep.run_grid_stream``) would otherwise wait on serial host numpy for
every configuration's trace; here spec, arrivals, job sizes and fault
streams of a chunk are built as torch ops on the chunk's device: template
jitter, coverage-repaired adjacency, diurnal and burst Bernoulli arrivals,
Lomax job sizes and the fault-event process.

Randomness: a counter-based hash, Threefry-2x32 with 20 rounds (Salmon et
al., SC'11), written in int64 torch ops masked to 32 bits. Draw ``d`` of
trace component ``stream`` of a configuration takes its element ``i``'s
32 bits from key (seed, ``STREAM_INDEX[stream]``) and counter (i, d). So

  * each trace component of a point depends only on (seed, stream), and
    ``STREAM_INDEX`` follows ``trace.STREAMS`` as the host path's
    ``trace.stream_rng`` does;
  * generating a grid in chunks gives the same bits as generating it
    whole (nothing depends on a row's position in the batch);
  * the integer bits are the same on the CPU and on the card, and so is
    the spec (its float32 arithmetic is products and sums only: every
    scale is divided on the host, since a tensor divided by a scalar on the
    card is multiplied by the reciprocal). Values that pass through
    ``sin``, ``log`` or ``pow`` may differ by an ulp between the two, so
    an arrival at a probability's edge can flip.

The bitstream differs from the host numpy path's and from the reference's
``jax.random`` one: device traces are held to statistical parity with the
host traces, which stay the bitwise-pinned golden path. Uniforms take the
top 24 bits (exact in float32), integers below n take (bits * n) >> 32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sched import trace

# hash key word 1 of each trace component: follows trace.STREAMS' order
STREAM_INDEX = {name: i for i, name in enumerate(trace.STREAMS)}

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_ROUNDS = 20
_U24 = 2.0 ** -24


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 of counter (c0, c1) under key (k0, k1): int64
    tensors (or ints) holding unsigned 32-bit values, broadcast together.
    Returns the two output words as int64 tensors in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for r in range(_ROUNDS):
        rot = _ROTATIONS[r % 8]
        x0 = (x0 + x1) & _M32
        x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _M32
        x1 = x1 ^ x0
        if r % 4 == 3:
            j = r // 4 + 1
            x0 = (x0 + ks[j % 3]) & _M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & _M32
    return x0, x1


def stream_bits(seeds: torch.Tensor, stream: str, sizes) -> list[torch.Tensor]:
    """The 32-bit draws of one trace component for every configuration:
    ``seeds`` (G,) int64 on the target device, ``sizes`` the element count
    of each draw, in draw order. Returns one (G, n) int64 tensor a draw,
    all from one hash over the concatenated counters."""
    dev = seeds.device
    c0 = torch.cat([torch.arange(n, dtype=torch.int64, device=dev) for n in sizes])
    c1 = torch.cat([torch.full((n,), d, dtype=torch.int64, device=dev)
                    for d, n in enumerate(sizes)])
    bits, _ = threefry2x32(seeds[:, None], STREAM_INDEX[stream], c0[None], c1[None])
    return list(torch.split(bits, list(sizes), dim=1))


def _uniform(bits: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [lo, hi) from the top 24 bits."""
    u = (bits >> 8).to(torch.float32) * _U24
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def _uniform_open0(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in (0, 1]: the inverse-CDF samplers take logs."""
    return ((bits >> 8) + 1).to(torch.float32) * _U24


def _randint(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Integers in [0, n) (multiply-shift, exact in int64)."""
    return (bits * n) >> 32


@dataclasses.dataclass(frozen=True)
class DeviceStatics:
    """The parameters one generation shares across its batch: shapes and
    distributions. Per-point values (seed, rho, contention, utility) come
    in as stacked tensors instead."""

    L: int
    R: int
    K: int
    T: int
    density: float
    alpha_range: tuple
    beta_range: tuple
    diurnal: bool
    burst_prob: float
    work_mean: float
    work_tail: float
    with_works: bool
    # the fault-event process (None when faults are not generated)
    faults: trace.FaultConfig = None
    with_faults: bool = False

    @classmethod
    def from_cfg(cls, cfg: trace.TraceConfig, with_works: bool, with_faults: bool = False):
        return cls(
            L=cfg.L, R=cfg.R, K=cfg.K, T=cfg.T, density=cfg.density,
            alpha_range=tuple(cfg.alpha_range), beta_range=tuple(cfg.beta_range),
            diurnal=cfg.diurnal, burst_prob=cfg.burst_prob,
            work_mean=cfg.work_mean, work_tail=cfg.work_tail,
            with_works=with_works,
            faults=cfg.faults if with_faults else None,
            with_faults=with_faults,
        )


def _build_spec(seeds, scale, kinds, beta, st: DeviceStatics) -> ClusterSpec:
    """Device twin of ``trace.build_spec`` for G configurations."""
    G, L, R, K = seeds.shape[0], st.L, st.R, st.K
    dev = seeds.device
    b_c, b_cj, b_aj, b_mask, b_row, b_col, b_alpha = stream_bits(
        seeds, "spec", (R, R * K, L * K, L * R, L, R, R * K))
    machines = torch.tensor(trace.MACHINE_TEMPLATES[:, :K], dtype=torch.float32, device=dev)
    jobs = torch.tensor(trace.JOB_TEMPLATES[:, :K], dtype=torch.float32, device=dev)
    # instances drawn from templates with +-20% jitter
    c = machines[_randint(b_c, machines.shape[0])] * _uniform(b_cj, 0.8, 1.2).view(G, R, K)
    c = torch.clamp_min(c, 1.0)
    # job types cycle through templates with jitter, scaled by contention
    j_idx = torch.arange(L, device=dev) % jobs.shape[0]
    a = jobs[j_idx] * _uniform(b_aj, 0.9, 1.1).view(G, L, K)
    a = torch.clamp_min(a, 0.25) * scale[:, None, None]
    # adjacency with guaranteed coverage (the host path's repair rule,
    # branch-free: a uniform index per row and per column, applied only
    # where the row or column came out empty)
    compat_any = ((a[:, :, None, :] > 0) & (c[:, None, :, :] > 0)).any(-1)   # (G, L, R)
    mask = (_uniform(b_mask).view(G, L, R) < st.density) & compat_any
    row_fix = F.one_hot(_randint(b_row, R), R).bool()                        # (G, L, R)
    mask = mask | (~mask.any(-1, keepdim=True) & row_fix)
    col_fix = F.one_hot(_randint(b_col, L), L).bool().transpose(-1, -2)      # (G, L, R)
    mask = mask | (~mask.any(-2, keepdim=True) & col_fix)
    alpha = _uniform(b_alpha, *st.alpha_range).view(G, R, K)
    return ClusterSpec(mask=mask.to(torch.float32), a=a, c=c, alpha=alpha,
                       beta=beta, kinds=kinds)


def _windows(starts: torch.Tensor, length: int) -> torch.Tensor:
    """(G, T, n) bool: a start fell in (t - length, t] (cumsum difference,
    the host path's window rule)."""
    cum = torch.cumsum(starts.to(torch.int32), dim=1)
    shifted = F.pad(cum, (0, 0, length, 0))[:, : starts.shape[1]]
    return (cum - shifted) > 0


def _build_arrivals(seeds, rho, st: DeviceStatics) -> torch.Tensor:
    """Device twin of ``trace.build_arrivals``: (G, T, L) Bernoulli
    indicators with diurnal modulation and BURST_LEN-slot bursts."""
    G, T, L = seeds.shape[0], st.T, st.L
    b_phase, b_start, b_draw = stream_bits(seeds, "arrivals", (L, T * L, T * L))
    base = rho[:, None, None].expand(G, T, L)
    if st.diurnal:
        t = torch.arange(T, dtype=torch.float32, device=seeds.device)[:, None]
        phase = _uniform(b_phase, 0.0, 2.0 * math.pi).view(G, 1, L)
        base = base * (0.75 + 0.25 * torch.sin(t * (2.0 * math.pi / 288.0) + phase))
    burst = _windows(_uniform(b_start).view(G, T, L) < st.burst_prob, trace.BURST_LEN)
    p = torch.clamp(torch.where(burst, 0.95, base), 0.0, 1.0)
    return (_uniform(b_draw).view(G, T, L) < p).to(torch.float32)


def _build_works(seeds, st: DeviceStatics) -> torch.Tensor:
    """Device twin of ``trace.build_works``: (G, T, L) Lomax job sizes of
    mean ``work_mean`` and tail index ``work_tail`` (inverse CDF: Pareto
    = u^(-1/tail) - 1, u in (0, 1])."""
    G, T, L = seeds.shape[0], st.T, st.L
    (bits,) = stream_bits(seeds, "works", (T * L,))
    scale = st.work_mean * (st.work_tail - 1.0) / st.work_tail
    pareto = _uniform_open0(bits).view(G, T, L) ** (-1.0 / st.work_tail) - 1.0
    return scale * (1.0 + pareto)


def _build_faults(seeds, st: DeviceStatics) -> torch.Tensor:
    """Device twin of ``trace.build_faults``: (G, T, K) capacity
    multipliers. The same event model, family by family: Bernoulli failure
    starts with geometric repair windows (inverse CDF, ceil(log u /
    log(1 - p))), overlap-counted by a difference-array scatter and a
    cumsum; modular drain windows at a seeded phase per resource; shock
    windows by the cumsum difference of the arrival bursts. Each family
    has its own draw, so disabling one never shifts another's bits."""
    fc = st.faults
    G, T, K = seeds.shape[0], st.T, st.K
    dev = seeds.device
    if fc is None or not fc.active:
        return torch.ones((G, T, K), dtype=torch.float32, device=dev)
    b_start, b_dur, b_drain, b_shock = stream_bits(seeds, "faults", (T * K, T * K, K, T * K))
    mult = torch.ones((G, T, K), dtype=torch.float32, device=dev)
    t = torch.arange(T, device=dev)[:, None]
    if fc.fail_rate > 0.0:
        startsf = (_uniform(b_start).view(G, T, K) < fc.fail_rate).to(torch.float32)
        p = 1.0 / max(fc.repair_mean, 1.0)
        dur = torch.clamp_min(torch.ceil(torch.log(_uniform_open0(b_dur).view(G, T, K))
                                         * (1.0 / math.log1p(-p))), 1.0).to(torch.int64)
        ends = torch.clamp_max(t + dur, T)
        depth = torch.zeros((G, T + 1, K), dtype=torch.float32, device=dev)
        depth[:, :T] += startsf
        depth.scatter_add_(1, ends, -startsf)
        mult = mult * (1.0 - fc.fail_frac) ** torch.cumsum(depth[:, :T], dim=1)
    if fc.drain_period > 0:
        phase = _randint(b_drain, fc.drain_period).view(G, 1, K)
        draining = (t + phase) % fc.drain_period < fc.drain_len
        mult = torch.where(draining, mult * (1.0 - fc.drain_frac), mult)
    if fc.shock_rate > 0.0:
        shock = _windows(_uniform(b_shock).view(G, T, K) < fc.shock_rate, fc.shock_len)
        mult = torch.where(shock, mult * fc.shock_depth, mult)
    return torch.clamp(mult, 0.0, 1.0)


def make_batch(cfgs, with_works: bool = False, with_faults: bool = False,
               device: DeviceLike = None):
    """``trace.make_batch`` generated on ``device`` (None: the CUDA card):
    (spec, arrivals, works, faults), every field leading (G,); ``works``
    and ``faults`` None unless requested.

    All configs must share (L, R, K, T) and the distributional statics
    (density, jitter ranges, burst probability, work distribution, fault
    process): the per-point axes are seed, rho, contention and utility,
    the axes ``sweep.make_grid`` varies. Utility kinds and beta are
    deterministic per point (``trace.spec_kinds`` / ``spec_beta``). Seeds
    must lie in [0, 2^32), the hash key's word.
    """
    cfgs = trace.check_batch_cfgs(cfgs)
    statics = {DeviceStatics.from_cfg(c, with_works, with_faults) for c in cfgs}
    if len(statics) > 1:
        raise ValueError(
            "device trace batches must share all static trace parameters "
            f"(density, jitter ranges, burst/work distribution); got {statics}"
        )
    st = statics.pop()
    bad = [c.seed for c in cfgs if not 0 <= int(c.seed) < 2 ** 32]
    if bad:
        raise ValueError(
            "device trace synthesis keys its hash with a 32-bit word: seeds "
            f"must lie in [0, 2**32), got {bad[:3]}{'...' if len(bad) > 3 else ''}. "
            "Remap the seed axis, or use trace_backend='host' (SeedSequence "
            "accepts arbitrary non-negative ints)."
        )
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    seeds = torch.tensor([int(c.seed) for c in cfgs], dtype=torch.int64, device=dev)
    rho = torch.tensor([c.rho for c in cfgs], **f32)
    # contention / 10, the request scale, divided on the host: a tensor
    # divided by a scalar on the card is multiplied by its reciprocal
    scale = torch.tensor([c.contention / 10.0 for c in cfgs], **f32)
    kinds = torch.from_numpy(np.stack([trace.spec_kinds(c) for c in cfgs]).astype(np.int32)).to(dev)
    beta = torch.from_numpy(np.stack([trace.spec_beta(c) for c in cfgs]).astype(np.float32)).to(dev)
    spec = _build_spec(seeds, scale, kinds, beta, st)
    arrivals = _build_arrivals(seeds, rho, st)
    works = _build_works(seeds, st) if with_works else None
    faults = _build_faults(seeds, st) if with_faults else None
    return spec, arrivals, works, faults
