"""Trace-driven cluster simulator (paper §4), slot and lifecycle mode.

Counterpart of ``repro.sched.simulator``: one configuration, OGASCHED
against the baselines through ``sweep.run_algorithm`` (slot mode, with the
Thm. 1 regret certificate on request) or ``lifecycle.run`` (jobs hold
their allocation until their work drains, optionally under the trace's
capacity faults).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines, regret
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sched import lifecycle, sweep, trace


@dataclasses.dataclass
class SimResult:
    name: str
    rewards: np.ndarray           # (T,)
    avg_reward: float
    cumulative: float
    wall_s: float
    regret: Optional[float] = None
    regret_bound: Optional[float] = None
    # lifecycle mode: lifecycle.summarize's metrics (jct_mean, jct_p99,
    # slowdown_mean, utilization[/k], completed, dropped, goodput, ...)
    lifecycle: Optional[dict] = None


def run_all(
    cfg: trace.TraceConfig,
    eta0: float = 25.0,
    decay: float = 0.9999,
    algorithms: tuple = ("ogasched",) + baselines.BASELINES,
    with_regret: bool = False,
    oracle_iters: int = 2000,
    backend: str = "auto",
    mode: str = "slot",
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    device: DeviceLike = None,
) -> dict[str, SimResult]:
    """Single-configuration comparison of ``algorithms`` on the trace of
    ``cfg``, on ``device`` (None: the CUDA card). ``wall_s`` is each
    algorithm's time from start to its rewards on the host.

    mode="lifecycle" runs the job lifecycle (``lifecycle.run``) and fills
    ``SimResult.lifecycle``; an active ``cfg.faults`` injects its fault
    stream (``trace.build_faults``) with ``fault_policy`` (lifecycle mode
    only: slot mode raises). Regret is a slot-mode notion, so
    ``with_regret`` applies in slot mode only.
    """
    if mode not in sweep.MODES:
        raise ValueError(f"mode must be 'slot' or 'lifecycle', got {mode!r}")
    has_faults = sweep.needs_faults([sweep.SweepPoint(cfg=cfg)], mode)
    dev = resolve_device(device)
    spec, arrivals = trace.make(cfg, device=dev)
    works = trace.build_works(cfg, dev) if sweep.needs_works(algorithms, mode) else None
    faults = trace.build_faults(cfg, dev) if has_faults else None
    y_star = None
    if with_regret and mode == "slot" and "ogasched" in algorithms:
        y_star = regret.offline_optimum(spec, arrivals, iters=oracle_iters, device=dev)
    out: dict[str, SimResult] = {}
    for name in algorithms:
        t0 = time.perf_counter()
        metrics = None
        if mode == "lifecycle":
            tr = lifecycle.run(spec, arrivals, works, name, eta0=eta0, decay=decay,
                               backend=backend, queue_depth=queue_depth,
                               rate_floor=rate_floor, faults=faults,
                               fault_policy=fault_policy, device=dev)
            rewards_t = tr.rewards
            # the batched reduction on a one-row grid: the path
            # sweep.summarize_lifecycle runs over whole grids
            batched = lifecycle.summarize_batch(
                lifecycle.LifecycleTrace(*(getattr(tr, f)[None]
                                           for f in lifecycle.LifecycleTrace.FIELDS)),
                ClusterSpec.stack([spec]))
            metrics = {k: float(v[0]) for k, v in batched.items()}
        else:
            rewards_t = sweep.run_algorithm(
                spec, arrivals, name, eta0=eta0, decay=decay, backend=backend,
                works=works if name in baselines.SIZE_AWARE else None, device=dev,
            )
        rewards = rewards_t.cpu().numpy()
        res = SimResult(
            name=name,
            rewards=rewards,
            avg_reward=float(rewards.mean()),
            cumulative=float(rewards.sum()),
            wall_s=time.perf_counter() - t0,
            lifecycle=metrics,
        )
        if y_star is not None and name == "ogasched":
            res.regret = float(regret.regret(spec, arrivals, rewards_t, y_star))
            res.regret_bound = float(regret.regret_bound(spec, cfg.T))
        out[name] = res
    return out


def improvement_over_baselines(results: dict[str, SimResult]) -> dict[str, float]:
    """OGASCHED's signed-safe percentage improvement per baseline."""
    oga = results["ogasched"].avg_reward
    return {
        n: float(sweep.improvement_pct(oga, r.avg_reward))
        for n, r in results.items()
        if n != "ogasched"
    }
