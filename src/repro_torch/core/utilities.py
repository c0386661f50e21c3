"""Concave utility families f_r^k (paper eq. 51) and their derivatives.

Counterpart of ``repro.core.utilities``: the same seven kinds, the same
branch formulas, selected elementwise by ``torch.where`` so every branch is
evaluated exactly as the reference evaluates it.
"""
from __future__ import annotations

import torch

UTIL_LINEAR = 0
UTIL_LOG = 1
UTIL_RECIPROCAL = 2
UTIL_POLY = 3
UTIL_POW25 = 4
UTIL_POW75 = 5
UTIL_EXPSAT = 6
NUM_KINDS = 7

# The first four families; "mixed" trace specs cycle over exactly these
# (sched.trace.spec_kinds), which keeps the pinned trace digests stable.
NUM_SEED_KINDS = 4

KIND_NAMES = {
    UTIL_LINEAR: "linear",
    UTIL_LOG: "log",
    UTIL_RECIPROCAL: "reciprocal",
    UTIL_POLY: "poly",
    UTIL_POW25: "pow25",
    UTIL_POW75: "pow75",
    UTIL_EXPSAT: "expsat",
}
NAME_TO_KIND = {v: k for k, v in KIND_NAMES.items()}


def _select(kinds: torch.Tensor, branches, out: torch.Tensor) -> torch.Tensor:
    for kind, b in enumerate(branches):
        out = torch.where(kinds == kind, b, out)
    return out


def util_value(kinds: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f_r^k(y) (eq. 51). ``kinds`` broadcasts against ``y``."""
    y = torch.clamp_min(y, 0.0)
    branches = [
        alpha * y,                                   # linear
        alpha * torch.log1p(y),                      # log
        1.0 / alpha - 1.0 / (y + alpha),             # reciprocal
        alpha * torch.sqrt(y + 1.0) - alpha,         # poly
        alpha * ((y + 1.0) ** 0.25 - 1.0),           # pow25
        alpha * ((y + 1.0) ** 0.75 - 1.0),           # pow75
        alpha * -torch.expm1(-y),                    # expsat
    ]
    return _select(kinds, branches, torch.zeros_like(y * alpha))


def util_grad(kinds: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(f_r^k)'(y)."""
    y = torch.clamp_min(y, 0.0)
    shape = torch.broadcast_shapes(y.shape, alpha.shape)
    branches = [
        alpha.expand(shape),
        alpha / (1.0 + y),
        1.0 / torch.square(y + alpha),
        alpha / (2.0 * torch.sqrt(y + 1.0)),
        0.25 * alpha * (y + 1.0) ** -0.75,
        0.75 * alpha * (y + 1.0) ** -0.25,
        alpha * torch.exp(-y),
    ]
    return _select(kinds, branches, torch.zeros(shape, dtype=y.dtype, device=y.device))


def util_grad_at_zero(kinds: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """varpi_r^k = (f_r^k)'(0), the bound Thm. 1 uses (eq. 13)."""
    branches = [
        alpha,
        alpha,
        1.0 / torch.square(alpha),
        alpha / 2.0,
        alpha / 4.0,
        3.0 * alpha / 4.0,
        alpha,
    ]
    return _select(kinds, branches, torch.zeros_like(alpha))
