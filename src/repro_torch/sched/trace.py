"""Synthetic Alibaba-like trace generation (paper §4 'Traces'), host path.

Counterpart of ``repro.sched.trace``. The host numpy path uses the same
machine and job templates, the same seeded numpy streams and draw order,
so the port's specs, arrivals and job sizes are the reference's bits
exactly (pinned against the SHA-256 digests of tests/test_trace.py); the
arrays are built in numpy and moved to the device once.
``make_batch(trace_backend="device")`` generates a batch on the device
instead (``sched.trace_device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import utilities
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device

# Machine templates: capacities per resource type
# K = 6: [CPU cores, MEM (GB/4), GPU (sm-slices), NPU, TPU, FPGA]  (Tab. 2)
MACHINE_TEMPLATES = np.array(
    [
        # cpu   mem   gpu  npu  tpu  fpga
        [96.0, 90.0, 16.0, 0.0, 0.0, 0.0],   # GPU box (v100x8-ish)
        [128.0, 128.0, 0.0, 16.0, 0.0, 0.0],  # NPU box
        [96.0, 64.0, 0.0, 0.0, 32.0, 0.0],   # TPU host
        [64.0, 48.0, 8.0, 0.0, 0.0, 8.0],    # FPGA/mixed
        [192.0, 180.0, 4.0, 4.0, 4.0, 4.0],  # fat general node
        [48.0, 32.0, 2.0, 0.0, 0.0, 0.0],    # small worker
    ]
)

# Job-type templates: max requests per resource type (before contention mult.)
JOB_TEMPLATES = np.array(
    [
        [8.0, 16.0, 4.0, 0.0, 0.0, 0.0],   # distributed DNN training
        [4.0, 8.0, 0.0, 4.0, 0.0, 0.0],    # NPU inference service
        [16.0, 32.0, 0.0, 0.0, 0.0, 0.0],  # graph computation (CPU/mem)
        [2.0, 4.0, 0.0, 0.0, 8.0, 0.0],    # TPU training
        [8.0, 8.0, 2.0, 0.0, 0.0, 2.0],    # video transcoding (FPGA)
        [4.0, 32.0, 0.0, 0.0, 0.0, 0.0],   # in-memory analytics
        [8.0, 8.0, 1.0, 1.0, 1.0, 0.0],    # federated-learning aggregator
        [2.0, 2.0, 2.0, 0.0, 0.0, 0.0],    # notebook / interactive
        [32.0, 16.0, 0.0, 0.0, 0.0, 4.0],  # scientific batch
        [6.0, 12.0, 8.0, 0.0, 0.0, 0.0],   # LLM serving
    ]
)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault-event process of a trace (the reference's fields and
    defaults): three per-resource event families that compose
    multiplicatively into the (T, K) capacity multipliers of
    ``build_faults``, read by the job lifecycle only.

    * failures: a failure starts with probability ``fail_rate`` per slot
      and resource, removes ``fail_frac`` of the capacity and repairs after
      a geometric number of slots of mean ``repair_mean``; d overlapping
      failures leave ``(1 - fail_frac)**d``.
    * drains: every ``drain_period`` slots (a seeded phase per resource)
      the resource loses ``drain_frac`` for ``drain_len`` slots; 0 is off.
    * shocks: with probability ``shock_rate`` a slot starts ``shock_len``
      slots at ``shock_depth`` of the capacity.

    The default is fault-free: ``active`` is False and ``build_faults``
    returns ones."""

    fail_rate: float = 0.0      # P[failure event starts] per slot, resource
    fail_frac: float = 0.25     # capacity fraction lost per failure event
    repair_mean: float = 50.0   # mean repair duration in slots (geometric)
    drain_period: int = 0       # slots between scheduled drains (0 = off)
    drain_len: int = 40         # slots a drain lasts
    drain_frac: float = 0.5     # capacity fraction removed while draining
    shock_rate: float = 0.0     # P[contention shock starts] per slot
    shock_len: int = 10         # slots a shock lasts
    shock_depth: float = 0.6    # capacity multiplier during a shock

    @property
    def active(self) -> bool:
        """Whether any event family can fire (capacity ever below 1.0)."""
        return (
            self.fail_rate > 0.0
            or self.drain_period > 0
            or self.shock_rate > 0.0
        )


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    L: int = 10
    R: int = 128
    K: int = 6
    T: int = 2000
    rho: float = 0.7            # job arrival probability (Tab. 2)
    contention: float = 10.0    # requirement multiplier (Tab. 2)
    density: float = 0.5        # P[(l, r) in E]
    alpha_range: tuple = (1.0, 1.5)
    beta_range: tuple = (0.3, 0.5)
    utility: str = "mixed"      # or linear/log/reciprocal/poly/...
    seed: int = 0
    diurnal: bool = True        # non-stationary arrival modulation
    burst_prob: float = 0.02    # prob. a slot starts a 20-slot burst
    work_mean: float = 60.0     # mean sampled job size (lifecycle mode)
    work_tail: float = 2.1      # Pareto tail index (heavy-tailed sizes)
    faults: FaultConfig = FaultConfig()


BURST_LEN = 20  # slots a burst keeps a port firing

# Independent RNG streams per trace component, spawned from one
# SeedSequence root (APPEND-ONLY: child i does not depend on how many
# children are spawned, so the existing streams keep their bits).
STREAMS = ("spec", "arrivals", "works", "faults", "cluster")


def stream_rng(seed: int, stream: str) -> np.random.Generator:
    """The seeded generator of one trace component (one of ``STREAMS``)."""
    children = np.random.SeedSequence(seed).spawn(len(STREAMS))
    return np.random.default_rng(children[STREAMS.index(stream)])


def spec_kinds(cfg: TraceConfig) -> np.ndarray:
    """(K,) utility-family indices: "mixed" cycles over the four seed
    families, any other name selects one family."""
    if cfg.utility == "mixed":
        return np.arange(cfg.K) % utilities.NUM_SEED_KINDS
    return np.full(cfg.K, utilities.NAME_TO_KIND[cfg.utility])


def spec_beta(cfg: TraceConfig) -> np.ndarray:
    """(K,) communication-overhead coefficients (deterministic linspace)."""
    return np.linspace(cfg.beta_range[0], cfg.beta_range[1], cfg.K)


def _to(arr: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(dev)


def build_spec(cfg: TraceConfig, device: DeviceLike = None) -> ClusterSpec:
    dev = resolve_device(device)
    rng = stream_rng(cfg.seed, "spec")
    # instances drawn from templates with +-20% jitter
    t_idx = rng.integers(0, len(MACHINE_TEMPLATES), cfg.R)
    c = MACHINE_TEMPLATES[t_idx][:, : cfg.K] * rng.uniform(0.8, 1.2, (cfg.R, cfg.K))
    c = np.maximum(c, 1.0)
    # job types cycle through templates with jitter, scaled by contention
    j_idx = np.arange(cfg.L) % len(JOB_TEMPLATES)
    a = JOB_TEMPLATES[j_idx][:, : cfg.K] * rng.uniform(0.9, 1.1, (cfg.L, cfg.K))
    a = np.maximum(a, 0.25) * cfg.contention / 10.0
    # adjacency: random with guaranteed coverage; jobs only connect to
    # instances that have any of their dominant resources
    compat = (a[:, None, :] > 0) & (c[None, :, :] > 0)
    mask = (rng.uniform(size=(cfg.L, cfg.R)) < cfg.density) & compat.any(-1)
    # coverage repair: one uniform index per uncovered row, then per
    # uncovered column (the reference's draw order)
    empty_l = np.nonzero(~mask.any(axis=1))[0]
    if empty_l.size:
        mask[empty_l, rng.integers(0, cfg.R, size=empty_l.size)] = True
    empty_r = np.nonzero(~mask.any(axis=0))[0]
    if empty_r.size:
        mask[rng.integers(0, cfg.L, size=empty_r.size), empty_r] = True
    alpha = rng.uniform(*cfg.alpha_range, (cfg.R, cfg.K))
    return ClusterSpec(
        mask=_to(mask, np.float32, dev),
        a=_to(a, np.float32, dev),
        c=_to(c, np.float32, dev),
        alpha=_to(alpha, np.float32, dev),
        beta=_to(spec_beta(cfg), np.float32, dev),
        kinds=_to(spec_kinds(cfg), np.int32, dev),
    )


def build_arrivals(cfg: TraceConfig, multi: bool = False,
                   device: DeviceLike = None) -> torch.Tensor:
    """(T, L) arrival indicators (float32), or counts (int32) when ``multi``."""
    dev = resolve_device(device)
    rng = stream_rng(cfg.seed, "arrivals")
    base = np.full((cfg.T, cfg.L), cfg.rho)
    if cfg.diurnal:
        t = np.arange(cfg.T)[:, None]
        phase = rng.uniform(0, 2 * np.pi, (1, cfg.L))
        base = base * (0.75 + 0.25 * np.sin(2 * np.pi * t / 288.0 + phase))
    # bursts: burst[t] iff any start fell in (t - BURST_LEN, t]
    starts = rng.uniform(size=(cfg.T, cfg.L)) < cfg.burst_prob
    cum = np.cumsum(starts, axis=0)
    burst = (cum - np.pad(cum, ((BURST_LEN, 0), (0, 0)))[: cfg.T]) > 0
    p = np.clip(np.where(burst, 0.95, base), 0.0, 1.0)
    if multi:
        return _to(rng.poisson(p * 2.0), np.int32, dev)
    return _to(rng.uniform(size=p.shape) < p, np.float32, dev)


def build_works(cfg: TraceConfig, device: DeviceLike = None) -> torch.Tensor:
    """(T, L) heavy-tailed (Lomax) job sizes with mean ``cfg.work_mean``."""
    dev = resolve_device(device)
    rng = stream_rng(cfg.seed, "works")
    scale = cfg.work_mean * (cfg.work_tail - 1.0) / cfg.work_tail
    w = scale * (1.0 + rng.pareto(cfg.work_tail, size=(cfg.T, cfg.L)))
    return _to(w, np.float32, dev)


def build_faults(cfg: TraceConfig, device: DeviceLike = None) -> torch.Tensor:
    """(T, K) float32 capacity multipliers in [0, 1] of the seeded
    fault-event process (``FaultConfig``): the lifecycle runs slot t
    against ``c * mult[t]``. The reference's draw order, each family drawn
    only when it can fire: failure starts, failure durations, drain
    phases, shock starts; so the bits are the reference's. A fault-free
    config draws nothing and returns ones."""
    dev = resolve_device(device)
    fc = cfg.faults
    T, K = cfg.T, cfg.K
    if not fc.active:
        return _to(np.ones((T, K)), np.float32, dev)
    rng = stream_rng(cfg.seed, "faults")
    mult = np.ones((T, K))
    if fc.fail_rate > 0.0:
        starts = rng.uniform(size=(T, K)) < fc.fail_rate
        dur = rng.geometric(1.0 / max(fc.repair_mean, 1.0), size=(T, K))
        t_idx, k_idx = np.nonzero(starts)
        ends = np.minimum(t_idx + dur[t_idx, k_idx], T)
        # concurrent failures per (t, k): a difference array and a cumsum
        depth = np.zeros((T + 1, K))
        np.add.at(depth, (t_idx, k_idx), 1.0)
        np.add.at(depth, (ends, k_idx), -1.0)
        mult = mult * (1.0 - fc.fail_frac) ** np.cumsum(depth[:T], axis=0)
    if fc.drain_period > 0:
        phase = rng.integers(0, fc.drain_period, size=K)
        t = np.arange(T)[:, None]
        draining = (t + phase[None, :]) % fc.drain_period < fc.drain_len
        mult = np.where(draining, mult * (1.0 - fc.drain_frac), mult)
    if fc.shock_rate > 0.0:
        s_starts = rng.uniform(size=(T, K)) < fc.shock_rate
        cum = np.cumsum(s_starts, axis=0)
        in_shock = (cum - np.pad(cum, ((fc.shock_len, 0), (0, 0)))[:T]) > 0
        mult = np.where(in_shock, mult * fc.shock_depth, mult)
    return _to(np.clip(mult, 0.0, 1.0), np.float32, dev)


def make(cfg: TraceConfig, device: DeviceLike = None):
    """(spec, arrivals) of one config on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    return build_spec(cfg, dev), build_arrivals(cfg, device=dev)


def make_lifecycle(cfg: TraceConfig, device: DeviceLike = None):
    """(spec, arrivals, works) of one config, for lifecycle-mode runs."""
    dev = resolve_device(device)
    return build_spec(cfg, dev), build_arrivals(cfg, device=dev), build_works(cfg, dev)


TRACE_BACKENDS = ("host", "device")


def check_batch_cfgs(cfgs) -> list:
    """Validate a trace batch: non-empty, rectangular (L, R, K, T)."""
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("empty trace batch")
    shapes = {(c.L, c.R, c.K, c.T) for c in cfgs}
    if len(shapes) > 1:
        raise ValueError(f"trace configs must share (L, R, K, T); got {shapes}")
    return cfgs


def make_batch(cfgs, with_works: bool = False, trace_backend: str = "host",
               device: DeviceLike = None, with_faults: bool = False):
    """Stacked traces of a batch of configs on ``device`` (None: the CUDA
    card): (spec, arrivals, works, faults) with a leading (G,) axis on
    every field; ``works`` and ``faults`` are None unless requested
    (fault-free configs contribute rows of ones).

    ``trace_backend`` picks where the randomness is drawn:

    * ``"host"`` (default): the bitwise-pinned numpy path, one
      ``build_spec``/``build_arrivals``/``build_works``/``build_faults`` per
      config, stacked; equal to ``make`` config by config and to the
      reference's bits.
    * ``"device"``: one batched generation on the device
      (``sched.trace_device``), statistically equivalent traces from a
      counter-based hash, at a fraction of the host cost for streamed
      chunks.
    """
    cfgs = check_batch_cfgs(cfgs)
    if trace_backend == "device":
        from repro_torch.sched import trace_device

        return trace_device.make_batch(cfgs, with_works=with_works,
                                       with_faults=with_faults, device=device)
    if trace_backend != "host":
        raise ValueError(
            f"trace_backend must be one of {TRACE_BACKENDS}, got {trace_backend!r}"
        )
    dev = resolve_device(device)
    spec = ClusterSpec.stack([build_spec(c, dev) for c in cfgs])
    arrivals = torch.stack([build_arrivals(c, device=dev) for c in cfgs])
    works = torch.stack([build_works(c, dev) for c in cfgs]) if with_works else None
    faults = torch.stack([build_faults(c, dev) for c in cfgs]) if with_faults else None
    return spec, arrivals, works, faults
