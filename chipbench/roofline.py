"""The yardstick of the kernels' roofline shares: the H100's peaks and the
work of each kernel, counted from the problem and not from its layout.

Peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates:
3.35 TB/s of HBM bandwidth and 67 TFLOP/s of float32 outside the tensor
cores (989 TFLOP/s bf16 on them, unused here).

Bytes are the spec-level operands in float32, each read once, and the
output written once, so a kernel that packs, fuses or re-lays its operands
is measured against the same count. Operations: the gradient and ascent
take FLOPS_PER_LANE a (port, instance, resource) lane; the projection of an
(r, k) row of L ports a comparison sort (L ceil(log2 L)) and a scan (2 L).
The least time is the larger of bytes / bandwidth and operations / rate.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32_BYTES = 4
# gradient of eq. 30 (utility derivative, penalty, mask) and the ascent
FLOPS_PER_LANE = 16


def _projection_ops(L: int, rows: int) -> float:
    return rows * (L * math.ceil(math.log2(L)) + 2 * L)


def fused_step(L: int, R: int, K: int) -> dict:
    """One OGA slot update (gradient, ascent, projection) of an (L, R, K)
    decision: y in and out, mask (L, R), c and alpha (R, K), a (L, K),
    x (L), beta and kinds (K)."""
    lanes = L * R * K
    words = 2 * lanes + L * R + 2 * R * K + L * K + L + 2 * K
    ops = FLOPS_PER_LANE * lanes + _projection_ops(L, R * K)
    return _bound(F32_BYTES * words, ops)


def projection(L: int, R: int, K: int) -> dict:
    """One projection of an (L, R, K) proposal onto the residual capacity:
    proposal and output, mask (L, R), residual capacity (R, K), a (L, K)."""
    words = 2 * L * R * K + L * R + R * K + L * K
    return _bound(F32_BYTES * words, _projection_ops(L, R * K))


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


KERNELS = {"fused_step": fused_step, "projection": projection}
