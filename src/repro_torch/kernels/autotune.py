"""Launch constants of the CUDA kernels.

The one home of the integers that shape a kernel launch (the
``hardcoded-tiling`` lint rule allows them only in a module at this path).
No tuner yet: every kernel here runs one thread block per row.

Each block holds the row's 2L breakpoints in P power-of-two slots of shared
memory, one slot per thread, so P is also the block's thread count: the
next power of two at or above 2L, and never below one warp (the block
reductions work warp by warp).
"""
from __future__ import annotations

WARP = 32                 # threads per warp: the smallest block
MAX_THREADS = 1024        # threads a Hopper block may hold
MAX_L = MAX_THREADS // 2  # widest row: 2L breakpoint slots fit in one block


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def slots_for(L: int) -> int:
    """Breakpoint slots (= threads) of the block that projects a row of
    ``L`` lanes: 32 at the Fig. 2 width L = 10, 256 at L = 100."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"row width L={L} outside the kernels' range 1..{MAX_L}")
    return max(WARP, next_pow2(2 * L))
