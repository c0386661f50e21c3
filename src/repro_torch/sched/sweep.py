"""The resident, slot-mode sweep engine and the comparison path it shares
with the simulator.

Counterpart of ``repro.sched.sweep``. A grid of configurations becomes one
stacked batch; OGASCHED's fused backend runs the whole grid with ONE
kernel launch per step (the grid axis flattened into the kernel's rows,
``ogasched.run_batch``), the heuristics through ``baselines.run_batch``.

  * ``make_grid``    — cartesian product of sweep axes -> list[SweepPoint].
  * ``build_batch``  — host traces (``trace.make_batch``) stacked on a
                       leading grid axis.
  * ``run_algorithm``— single-config rewards; the path ``simulator.run_all``
                       calls per algorithm.
  * ``run_grid``     — every algorithm over every configuration.
  * ``summarize``    — per-config averages and OGASCHED's improvements.

All points share (L, R, K, T). Not ported: the job lifecycle and its fault
streams (ROADMAP Queue 1, item 9); streaming, checkpoints, fingerprints and
the sharded grid, and the reference's ``run_grid`` parameters ``donate``,
``queue_depth``, ``rate_floor`` and ``fault_policy`` (item 10).
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
from repro_torch.sched import trace

ALGORITHMS = ("ogasched",) + baselines.BASELINES

MODES = ("slot", "lifecycle")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'slot' or 'lifecycle', got {mode!r}")
    if mode == "lifecycle":
        raise NotImplementedError(
            "mode='lifecycle' is not ported yet (ROADMAP Queue 1, item 9)"
        )


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One grid configuration: a trace plus OGA hyperparameters."""

    cfg: trace.TraceConfig
    eta0: float = 25.0
    decay: float = 0.9999


@dataclasses.dataclass
class SweepBatch:
    """Stacked operands for a grid of G configurations: every spec field
    and ``arrivals`` lead with (G,); ``points`` keeps each row's provenance
    in the same order. (The reference's job sizes and fault streams serve
    the lifecycle and heSRPT, which are not ported.)"""

    spec: ClusterSpec                      # every field (G, ...)
    arrivals: torch.Tensor                 # (G, T, L)
    eta0: torch.Tensor                     # (G,)
    decay: torch.Tensor                    # (G,)
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


def build_batch(
    points: Sequence[SweepPoint],
    mode: str = "slot",
    *,
    device: DeviceLike = None,
) -> SweepBatch:
    """Generate every point's trace on the host and stack it on ``device``
    (None: the CUDA card). Active fault configs are refused as in the
    reference: slot mode holds nothing across slots."""
    _check_mode(mode)
    if not points:
        raise ValueError("empty sweep grid")
    if any(p.cfg.faults.active for p in points):
        raise ValueError(
            "fault injection (cfg.faults) requires mode='lifecycle': slot "
            "mode holds nothing across slots, so capacity faults would be "
            "silently ignored"
        )
    spec, arrivals, _ = trace.make_batch([p.cfg for p in points], device=device)
    dev = arrivals.device
    return SweepBatch(
        spec=spec,
        arrivals=arrivals,
        eta0=torch.tensor([p.eta0 for p in points], dtype=torch.float32, device=dev),
        decay=torch.tensor([p.decay for p in points], dtype=torch.float32, device=dev),
        points=tuple(points),
    )


def run_algorithm(spec: ClusterSpec, arrivals, name: str, *, eta0=25.0,
                  decay=0.9999, backend: str = "auto",
                  works: Optional[torch.Tensor] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """(T,) per-slot rewards of one algorithm on one configuration."""
    if works is not None:
        raise NotImplementedError(
            "size-aware baselines are not ported yet (ROADMAP Queue 1, item 7)"
        )
    if name == "ogasched":
        rewards, _ = ogasched.run(spec, arrivals, eta0=eta0, decay=decay,
                                  backend=backend, device=device)
        return rewards
    return baselines.run(spec, arrivals, name, device=device)


def run_grid(
    batch: SweepBatch,
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    backend: str = "auto",
    mode: str = "slot",
    tiling=None,
) -> dict[str, torch.Tensor]:
    """{name: (G, T) rewards} for every algorithm over every configuration
    of ``batch``, on the batch's device, in ``algorithms`` order.

    ``backend`` applies to OGASCHED only. "fused" ("auto") flattens the
    grid into the fused kernel's rows: one launch per step for the whole
    grid (``ogasched.run_batch``), with ``tiling`` pinning its row block
    (default: the autotune cache). "reference" runs the spec-level update
    config by config, for A/B.
    """
    _check_mode(mode)
    dev = batch.arrivals.device
    out: dict[str, torch.Tensor] = {}
    for name in algorithms:
        if name != "ogasched":
            out[name] = baselines.run_batch(batch.spec, batch.arrivals, name, device=dev)
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
