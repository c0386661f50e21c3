"""Exact water-level projection of packed rows, standalone.

Counterpart of ``repro.kernels.sortscan.proj_sortscan``. ``proj_sortscan``
is the wrapper of the CUDA kernel ``proj_sortscan_kernel``
(``csrc/oga_step.cu``), which projects through the same ``__device__``
water level (``csrc/sortscan.cuh``) as the fused OGA step: on CUDA tensors
it launches the kernel, on CPU tensors it computes the plain version
``ref.proj_rows_sorted``.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _launch, autotune, ref


def proj_sortscan(z, a, mask, c, *, row_block=None) -> torch.Tensor:
    """Exact projection of rows of z (N, L) onto {0 <= y <= a,
    sum(y * mask) <= c}; a, mask: (N, L), c: (N,).

    CUDA tensors: one launch of the CUDA kernel, ``row_block`` rows per
    block (``autotune.DEFAULT_ROW_BLOCK`` when None), counted in
    ``proj_sortscan.launches`` and, by (N, L), in
    ``proj_sortscan.launches_by_shape``. CPU tensors: ``ref.proj_rows_sorted``.
    Raises for anything the kernel does not take.
    """
    if z.device.type == "cpu":
        return ref.proj_rows_sorted(z, a, mask, c)
    if z.device.type != "cuda":
        raise ValueError(f"proj_sortscan runs on cuda or cpu tensors, not {z.device}")
    N, L = z.shape
    _launch.check_operands(("z", "a", "mask", "c"), (z, a, mask, c),
                           [(N, L), (N, L), (N, L), (N,)])
    rb = _launch.check_row_block(row_block or autotune.DEFAULT_ROW_BLOCK, L, "sortscan")
    out = torch.empty_like(z)
    if N == 0:
        return out
    _launch.launch("oga_step.cu", "repro_proj_sortscan", (z, a, mask, c), out, L, rb,
                   method="sortscan")
    proj_sortscan.launches += 1
    proj_sortscan.launches_by_shape[(N, L)] += 1
    return out


proj_sortscan.launches = 0
proj_sortscan.launches_by_shape = collections.Counter()
