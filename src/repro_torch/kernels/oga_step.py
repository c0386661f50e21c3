"""The fused OGA slot update: gradient (eq. 30) + ascent + projection in
one pass over the packed rows.

Counterpart of ``repro.kernels.oga_step``. Row layout: row n = cell (r, k)
with L lanes (ports). The per-row scalars are the columns of ``scal``;
``SCAL_COLUMNS`` is the single definition of that layout (``kernels.ops``
builds it, ``kernels.ref`` unpacks it, ``csrc/oga_step.cu`` reads it).

The projection is chosen per call: ``method="sortscan"`` (the default) is
the exact breakpoint sweep, ``method="bisect"`` the seeded bisection with
``iters`` halvings, the A/B baseline. ``row_block`` and ``iters`` are the
tuned knobs (``kernels.autotune``; its defaults when None).

``oga_step_fused`` is the wrapper of the CUDA kernel ``oga_step_kernel``
(``csrc/oga_step.cu``): on CUDA tensors it launches the kernel, on CPU
tensors it computes the plain version ``ref.oga_step_ref``.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _launch, autotune, ref

SCAL_COLUMNS = ("alpha", "beta", "c", "kind", "eta")
NUM_SCAL = len(SCAL_COLUMNS)


def pack_scal_static(alpha, beta, c, kind) -> torch.Tensor:
    """Stack the static per-row scalars (N,) each into the leading
    (N, NUM_SCAL - 1) columns: everything in ``SCAL_COLUMNS`` except eta,
    which decays per step and is appended by ``with_eta``."""
    return torch.stack([alpha, beta, c, kind], dim=1)


def with_eta(scal_static: torch.Tensor, eta) -> torch.Tensor:
    """Append the eta column: ``eta`` is a scalar (one config) or per-row
    (N,) (grid-flattened batches)."""
    n = scal_static.shape[0]
    eta_col = torch.as_tensor(eta, dtype=scal_static.dtype,
                              device=scal_static.device).expand(n)
    return torch.cat([scal_static, eta_col[:, None]], dim=1)


def pack_scal(alpha, beta, c, kind, eta) -> torch.Tensor:
    """The full (N, NUM_SCAL) kernel operand in ``SCAL_COLUMNS`` order."""
    return with_eta(pack_scal_static(alpha, beta, c, kind), eta)


def oga_step_fused(y, a, mask, x, kstar, scal, *, method=None, row_block=None,
                   iters=None) -> torch.Tensor:
    """y(t+1) (N, L) from y, a, mask, x, kstar (N, L) and scal (N, NUM_SCAL).

    CUDA tensors: one launch of the CUDA kernel, ``row_block`` rows per
    block, counted in ``oga_step_fused.launches`` and, by (N, L), in
    ``oga_step_fused.launches_by_shape``. CPU tensors:
    ``ref.oga_step_ref`` with the same projection method. Raises for an
    unknown method and for any device, dtype, shape, layout or tiling the
    kernel does not take; there is no fallback from CUDA to the plain
    version.
    """
    meth = method or autotune.DEFAULT_PROJ_METHOD
    if meth not in autotune.PROJ_METHODS:
        raise ValueError(f"method must be in {autotune.PROJ_METHODS}, got {meth!r}")
    it = _launch.check_iters(iters or autotune.DEFAULT_BISECT_ITERS)
    if y.device.type == "cpu":
        return ref.oga_step_ref(y, a, mask, x, kstar, scal,
                                proj="sorted" if meth == "sortscan" else "bisect", iters=it)
    if y.device.type != "cuda":
        raise ValueError(f"oga_step_fused runs on cuda or cpu tensors, not {y.device}")
    N, L = y.shape
    _launch.check_operands(
        ("y", "a", "mask", "x", "kstar", "scal"), (y, a, mask, x, kstar, scal),
        [(N, L)] * 5 + [(N, NUM_SCAL)],
    )
    rb = _launch.check_row_block(row_block or autotune.DEFAULT_ROW_BLOCK, L, meth)
    out = torch.empty_like(y)
    if N == 0:
        return out
    _launch.launch("oga_step.cu", "repro_oga_step", (y, a, mask, x, kstar, scal), out,
                   L, rb, autotune.PROJ_METHODS.index(meth), it, method=meth)
    oga_step_fused.launches += 1
    oga_step_fused.launches_by_shape[(N, L)] += 1
    return out


oga_step_fused.launches = 0
oga_step_fused.launches_by_shape = collections.Counter()
