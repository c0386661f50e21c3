"""The part of the sweep engine the slot-mode main path uses.

Counterpart of ``repro.sched.sweep``: ``needs_works``, ``run_algorithm``
(the single comparison path ``simulator.run_all`` calls per algorithm) and
``improvement_pct``. The grid engine itself (``make_grid``, ``run_grid``,
streaming, checkpoints) is ROADMAP Queue 1, item 10.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import baselines, ogasched
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike


def needs_works(algorithms: Sequence[str], mode: str) -> bool:
    """Whether a run must carry job sizes: always in lifecycle mode, and in
    slot mode exactly when a size-aware baseline is in the pool."""
    return mode == "lifecycle" or any(a in baselines.SIZE_AWARE for a in algorithms)


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


def improvement_pct(oga, base, eps: float = 1e-9):
    """Signed-safe percentage improvement of ``oga`` over ``base``:
    100 (oga - base) / max(|base|, eps), finite at zero baselines and
    sign-correct at negative ones."""
    oga = np.asarray(oga, np.float64)
    base = np.asarray(base, np.float64)
    return 100.0 * (oga - base) / np.maximum(np.abs(base), eps)
