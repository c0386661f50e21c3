"""Trace-driven cluster simulator (paper §4), slot mode.

Counterpart of ``repro.sched.simulator``: one configuration, OGASCHED
against the four heuristics through ``sweep.run_algorithm``, optionally
with the Thm. 1 regret certificate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines, regret
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sched import sweep, trace


@dataclasses.dataclass
class SimResult:
    name: str
    rewards: np.ndarray           # (T,)
    avg_reward: float
    cumulative: float
    wall_s: float
    regret: Optional[float] = None
    regret_bound: Optional[float] = None


def run_all(
    cfg: trace.TraceConfig,
    eta0: float = 25.0,
    decay: float = 0.9999,
    algorithms: tuple = ("ogasched",) + baselines.BASELINES,
    with_regret: bool = False,
    oracle_iters: int = 2000,
    backend: str = "auto",
    mode: str = "slot",
    device: DeviceLike = None,
) -> dict[str, SimResult]:
    """Single-configuration comparison of ``algorithms`` on the trace of
    ``cfg``, on ``device`` (None: the CUDA card). ``wall_s`` is each
    algorithm's time from start to its rewards on the host.

    Only ``mode="slot"`` is ported; the job lifecycle is ROADMAP Queue 1,
    item 9.
    """
    if mode == "lifecycle":
        raise NotImplementedError(
            "mode='lifecycle' is not ported yet (ROADMAP Queue 1, item 9)"
        )
    if mode != "slot":
        raise ValueError(f"mode must be 'slot' or 'lifecycle', got {mode!r}")
    if cfg.faults.active:
        raise ValueError(
            "fault injection (cfg.faults) requires mode='lifecycle': slot "
            "mode holds nothing across slots, so capacity faults would be "
            "silently ignored"
        )
    dev = resolve_device(device)
    spec, arrivals = trace.make(cfg, device=dev)
    works = trace.build_works(cfg, dev) if sweep.needs_works(algorithms, mode) else None
    y_star = None
    if with_regret and "ogasched" in algorithms:
        y_star = regret.offline_optimum(spec, arrivals, iters=oracle_iters, device=dev)
    out: dict[str, SimResult] = {}
    for name in algorithms:
        t0 = time.perf_counter()
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
