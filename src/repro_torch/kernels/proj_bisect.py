"""Box-capped simplex projection of packed rows by seeded bisection.

Counterpart of ``repro.kernels.proj_bisect``. The water level is found by
bisection on a seeded bracket: g is 1-Lipschitz per active lane, so
lo = max((sum box - c) / n_active, 0) has g(lo) >= c, and hi = max z;
``iters`` halvings (``autotune.DEFAULT_BISECT_ITERS`` when None) and a
secant step clipped to the bracket finish it. |tau - tau*| is at most the
bracket width / 2^iters, so the result is within that of the exact sweep,
not bitwise. The exact ``proj_sortscan`` is the production projection;
this is the A/B baseline the tuner measures against it.

``proj_bisect`` is the wrapper of the CUDA kernel ``proj_bisect_kernel``
(``csrc/proj_bisect.cu`` over ``csrc/bisect.cuh``): on CUDA tensors it
launches the kernel, on CPU tensors it computes the plain version
``ref.proj_rows_bisect``. Operands are float32 or bf16, all of one type,
and the result has that type; the water level is solved in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, autotune, ref

# the C entry of each operand type
_SYMBOLS = {torch.float32: "repro_proj_bisect", torch.bfloat16: "repro_proj_bisect_bf16"}


def proj_bisect(z, a, mask, c, *, row_block=None, iters=None) -> torch.Tensor:
    """Project rows of z (N, L) onto {0 <= y <= a, sum(y * mask) <= c};
    a, mask: (N, L), c: (N,).

    CUDA tensors: one launch of the CUDA kernel, ``row_block`` rows per
    block, counted in ``proj_bisect.launches``. CPU tensors:
    ``ref.proj_rows_bisect`` with the same ``iters``. Raises for anything
    the kernel does not take.
    """
    it = _launch.check_iters(iters or autotune.DEFAULT_BISECT_ITERS)
    if z.device.type == "cpu":
        return ref.proj_rows_bisect(z, a, mask, c, iters=it)
    if z.device.type != "cuda":
        raise ValueError(f"proj_bisect runs on cuda or cpu tensors, not {z.device}")
    if z.dtype not in _SYMBOLS:
        raise TypeError(f"proj_bisect takes float32 or bfloat16, not {z.dtype}")
    N, L = z.shape
    _launch.check_operands(("z", "a", "mask", "c"), (z, a, mask, c),
                           [(N, L), (N, L), (N, L), (N,)], dtype=z.dtype)
    rb = _launch.check_row_block(row_block or autotune.DEFAULT_ROW_BLOCK, L, "bisect")
    out = torch.empty_like(z)
    if N == 0:
        return out
    _launch.launch("proj_bisect.cu", _SYMBOLS[z.dtype], (z, a, mask, c), out, L, rb, it,
                   method="bisect")
    proj_bisect.launches += 1
    return out


proj_bisect.launches = 0
