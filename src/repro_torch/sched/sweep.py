"""The resident sweep engine, slot mode and lifecycle mode, and the
comparison path it shares with the simulator.

Counterpart of ``repro.sched.sweep``. A grid of configurations becomes one
stacked batch; OGASCHED's fused backend runs the whole grid with ONE
kernel launch per step (the grid axis flattened into the kernel's rows,
``ogasched.run_batch``), the heuristics through ``baselines.run_batch``;
in lifecycle mode every algorithm runs ``lifecycle.run_batch``, the same
slot function over the G configurations.

  * ``make_grid``    — cartesian product of sweep axes -> list[SweepPoint].
  * ``build_batch``  — host traces (``trace.make_batch``) stacked on a
                       leading grid axis, with job sizes and fault streams
                       where the mode needs them.
  * ``run_algorithm``— single-config rewards; the path ``simulator.run_all``
                       calls per algorithm in slot mode.
  * ``run_grid``     — every algorithm over every configuration.
  * ``summarize`` / ``summarize_lifecycle`` — per-config metrics.

All points share (L, R, K, T). Not ported: streaming, checkpoints,
fingerprints and the sharded grid, and the reference's ``run_grid``
parameter ``donate`` (ROADMAP Queue 1, item 10b).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import baselines, ogasched
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.sched import lifecycle, trace

ALGORITHMS = ("ogasched",) + baselines.BASELINES

MODES = ("slot", "lifecycle")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'slot' or 'lifecycle', got {mode!r}")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One grid configuration: a trace plus OGA hyperparameters."""

    cfg: trace.TraceConfig
    eta0: float = 25.0
    decay: float = 0.9999


@dataclasses.dataclass
class SweepBatch:
    """Stacked operands for a grid of G configurations: every spec field
    and ``arrivals`` lead with (G,); ``works`` (job sizes, lifecycle mode
    and size-aware slot grids) and ``faults`` (capacity multipliers, when
    some point's fault process is active) are None otherwise; ``points``
    keeps each row's provenance in the same order."""

    spec: ClusterSpec                      # every field (G, ...)
    arrivals: torch.Tensor                 # (G, T, L)
    eta0: torch.Tensor                     # (G,)
    decay: torch.Tensor                    # (G,)
    works: Optional[torch.Tensor] = None   # (G, T, L)
    faults: Optional[torch.Tensor] = None  # (G, T, K)
    points: tuple[SweepPoint, ...] = ()

    @property
    def size(self) -> int:
        return self.arrivals.shape[0]


def make_grid(
    base: Optional[trace.TraceConfig] = None,
    *,
    eta0s: Sequence[float] = (25.0,),
    decays: Sequence[float] = (0.9999,),
    utilities: Sequence[str] = ("mixed",),
    seeds: Optional[Sequence[int]] = None,
    rhos: Optional[Sequence[float]] = None,
    contentions: Optional[Sequence[float]] = None,
) -> list[SweepPoint]:
    """Cartesian product of sweep axes over a base TraceConfig.

    Axis order (slowest to fastest): eta0, decay, utility, seed, rho,
    contention, as in the reference.
    """
    base = trace.TraceConfig() if base is None else base
    seeds = (base.seed,) if seeds is None else seeds
    rhos = (base.rho,) if rhos is None else rhos
    contentions = (base.contention,) if contentions is None else contentions
    points = []
    for eta0, decay, util, seed, rho, cont in itertools.product(
        eta0s, decays, utilities, seeds, rhos, contentions
    ):
        cfg = dataclasses.replace(base, utility=util, seed=seed, rho=rho, contention=cont)
        points.append(SweepPoint(cfg=cfg, eta0=eta0, decay=decay))
    return points


def needs_works(algorithms: Sequence[str], mode: str) -> bool:
    """Whether a run must carry job sizes: always in lifecycle mode, and in
    slot mode exactly when a size-aware baseline is in the pool."""
    return mode == "lifecycle" or any(a in baselines.SIZE_AWARE for a in algorithms)


def needs_faults(points: Sequence[SweepPoint], mode: str) -> bool:
    """Whether a grid must carry a fault stream: some point's fault process
    is active. Faults act in lifecycle mode only; an active fault config in
    slot mode raises instead of being ignored."""
    active = any(p.cfg.faults.active for p in points)
    if active and mode != "lifecycle":
        raise ValueError(
            "fault injection (cfg.faults) requires mode='lifecycle': slot "
            "mode holds nothing across slots, so capacity faults would be "
            "silently ignored"
        )
    return active


def build_batch(
    points: Sequence[SweepPoint],
    mode: str = "slot",
    *,
    with_works: Optional[bool] = None,
    device: DeviceLike = None,
) -> SweepBatch:
    """Generate every point's trace on the host and stack it on ``device``
    (None: the CUDA card). Lifecycle mode also samples job sizes (slot
    mode when ``with_works``, for size-aware baselines), and fault streams
    exactly when a point's ``cfg.faults`` is active (``needs_faults``)."""
    _check_mode(mode)
    if not points:
        raise ValueError("empty sweep grid")
    if with_works is None:
        with_works = mode == "lifecycle"
    spec, arrivals, works, faults = trace.make_batch(
        [p.cfg for p in points], with_works=with_works,
        with_faults=needs_faults(points, mode), device=device)
    dev = arrivals.device
    return SweepBatch(
        spec=spec,
        arrivals=arrivals,
        eta0=torch.tensor([p.eta0 for p in points], dtype=torch.float32, device=dev),
        decay=torch.tensor([p.decay for p in points], dtype=torch.float32, device=dev),
        works=works,
        faults=faults,
        points=tuple(points),
    )


def run_algorithm(spec: ClusterSpec, arrivals, name: str, *, eta0=25.0,
                  decay=0.9999, backend: str = "auto",
                  works: Optional[torch.Tensor] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """(T,) per-slot rewards of one algorithm on one configuration;
    size-aware baselines (``baselines.SIZE_AWARE``) consume ``works`` (T, L)
    job sizes."""
    if name == "ogasched":
        rewards, _ = ogasched.run(spec, arrivals, eta0=eta0, decay=decay,
                                  backend=backend, device=device)
        return rewards
    return baselines.run(spec, arrivals, name, device=device, works=works)


def run_grid(
    batch: SweepBatch,
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    backend: str = "auto",
    mode: str = "slot",
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    tiling=None,
) -> dict:
    """Every algorithm over every configuration of ``batch``, on the
    batch's device, in ``algorithms`` order.

    mode="slot": {name: (G, T) rewards}. ``backend`` applies to OGASCHED
    only. "fused" ("auto") flattens the grid into the fused kernel's rows:
    one launch per step for the whole grid (``ogasched.run_batch``), with
    ``tiling`` pinning its row block (default: the autotune cache).
    "reference" runs the spec-level update config by config, for A/B.

    mode="lifecycle": {name: LifecycleTrace} with fields leading (G, T),
    from ``lifecycle.run_batch`` (jobs hold resources until their work
    drains; ``batch.faults`` runs every row against its surviving
    capacity with ``fault_policy``); reduce with ``summarize_lifecycle``.
    """
    _check_mode(mode)
    if batch.works is None and needs_works(algorithms, mode):
        raise ValueError(
            "grid needs job sizes: build_batch(points, mode='lifecycle') "
            "or build_batch(points, with_works=True) for size-aware "
            "slot-mode baselines"
        )
    dev = batch.arrivals.device
    out: dict = {}
    for name in algorithms:
        if mode == "lifecycle":
            out[name] = lifecycle.run_batch(
                batch.spec, batch.arrivals, batch.works, name, eta0=batch.eta0,
                decay=batch.decay, queue_depth=queue_depth, rate_floor=rate_floor,
                backend=backend if name == "ogasched" else "reference",
                faults=batch.faults, fault_policy=fault_policy, device=dev)
        elif name != "ogasched":
            out[name] = baselines.run_batch(
                batch.spec, batch.arrivals, name, device=dev,
                works=batch.works if name in baselines.SIZE_AWARE else None)
        elif ops.resolve_oga_backend(backend) == "fused":
            out[name], _ = ogasched.run_batch(batch.spec, batch.arrivals, batch.eta0,
                                              batch.decay, device=dev, tiling=tiling)
        else:
            out[name] = torch.stack([
                run_algorithm(batch.spec[g], batch.arrivals[g], name,
                              eta0=batch.eta0[g], decay=batch.decay[g],
                              backend=backend, device=dev)
                for g in range(batch.size)
            ])
    return out


def improvement_pct(oga, base, eps: float = 1e-9):
    """Signed-safe percentage improvement of ``oga`` over ``base``:
    100 (oga - base) / max(|base|, eps), finite at zero baselines and
    sign-correct at negative ones."""
    oga = np.asarray(oga, np.float64)
    base = np.asarray(base, np.float64)
    return 100.0 * (oga - base) / np.maximum(np.abs(base), eps)


def summarize(rewards: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Per-config average rewards and OGASCHED's improvement percentages:
    {"avg/<name>": (G,), "improvement_pct/<name>": (G,)}, as
    ``simulator.improvement_over_baselines`` per grid row."""
    out = {f"avg/{n}": torch.as_tensor(r).cpu().numpy().mean(axis=1)
           for n, r in rewards.items()}
    if "ogasched" in rewards:
        oga = out["avg/ogasched"]
        for n in rewards:
            if n != "ogasched":
                out[f"improvement_pct/{n}"] = improvement_pct(oga, out[f"avg/{n}"])
    return out


def summarize_lifecycle(traces: dict, batch: SweepBatch) -> dict[str, np.ndarray]:
    """Per-config lifecycle metrics: {"<metric>/<name>": (G,)} for every
    scalar ``lifecycle.summarize`` reports, one batched reduction per
    algorithm (``lifecycle.summarize_batch``)."""
    out: dict[str, np.ndarray] = {}
    for name, tr in traces.items():
        for metric, v in lifecycle.summarize_batch(tr, batch.spec).items():
            out[f"{metric}/{name}"] = v.cpu().numpy()
    return out
