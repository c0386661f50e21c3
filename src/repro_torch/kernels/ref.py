"""Plain PyTorch versions of every kernel in this package.

They compute the same function as the CUDA kernels and serve as the CPU
path of each wrapper and as the yardstick ``chip_smoke.py`` holds each
kernel to on the card. Counterpart of ``repro.kernels.ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import projection as _proj
from repro_torch.core import utilities as U


def proj_rows_sorted(z, a, mask, c):
    """Exact breakpoint-sweep row projection (core.projection): all-pairs
    at narrow lanes, one sort + prefix sums at wide lanes."""
    return _proj.project_rows_sorted(z, a, mask, c)


def proj_rows_allpairs(z, a, mask, c):
    """The all-pairs O(L^2) breakpoint evaluation, forced."""
    return _proj.project_rows_allpairs(z, a, mask, c)


def proj_rows_sortscan(z, a, mask, c):
    """The one-sort + prefix-sum O(L log L) evaluation, forced."""
    return _proj.project_rows_sortscan(z, a, mask, c)


def proj_rows_exact_np(z, a, mask, c):
    """Exact float64 numpy oracle (breakpoint sweep) per row."""
    z = np.asarray(z, np.float64)
    a = np.asarray(a, np.float64)
    mask = np.asarray(mask)
    c = np.asarray(c, np.float64)
    out = np.zeros_like(z)
    for i in range(z.shape[0]):
        lanes = mask[i] > 0
        if lanes.any():
            out[i, lanes] = _proj.project_exact_np(z[i, lanes], a[i, lanes], float(c[i]))
    return out


def oga_step_ref(y, a, mask, x, kstar, scal):
    """Packed-row OGA update: gradient (eq. 30) -> ascent -> exact projection.

    y, a, mask, x, kstar: (N, L); ``scal`` (N, NUM_SCAL) with the columns of
    ``kernels.oga_step.SCAL_COLUMNS`` (alpha, beta, c, kind, eta). The
    gradient covers all seven utility kinds through ``utilities.util_grad``.
    """
    alpha, beta, c, kind, eta = scal.unbind(1)
    g = U.util_grad(kind[:, None].to(torch.int32), alpha[:, None], y * mask)
    g = g - beta[:, None] * kstar
    z = y + eta[:, None] * x * g * mask
    return proj_rows_sorted(z, a, mask, c)
