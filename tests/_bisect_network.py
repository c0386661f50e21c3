"""A float32 numpy emulation of the bisect water level
(``src/repro_torch/kernels/csrc/bisect.cuh``) as ``proj_bisect_kernel``
computes it, step for step.

The W threads of a row are the middle axis of (N, W, Q) arrays and the Q
ports a thread holds the last: thread j holds ports j + W q (padding past
L is z = a = m = 0). Every row sum is a thread's in-order sum over its Q
ports, then the xor butterfly over the W lanes (lane j adds lane j ^ o,
o = W/2 .. 1); a wide row (W = 512) reduces each warp of 32 so, and a
second butterfly runs over the 16 warps' results. Maxima likewise. The
kernel rounds every product, sum and quotient to nearest in float32
(``__fmul_rn`` and kin, never an FMA), so on the card it must give these
bits. Shared by tests/test_torch_bisect_layout.py (CPU) and
tests/test_torch_cuda.py (the card); imports nothing but numpy.
"""
import numpy as np

F32 = np.float32
NEG = F32(-1e30)
WARP = 32
NARROW_L = 16
WIDE_L = 256
WIDE_THREADS = 512


def layout(L: int) -> tuple[int, int]:
    """(W threads a row, Q ports a thread) of a row of L lanes."""
    p = WARP
    while p < 2 * L:
        p *= 2
    w = WARP // 2 if L <= NARROW_L else WARP if L <= WIDE_L else WIDE_THREADS
    return w, p // (2 * w)


def ports(x, w, q):
    """(N, L) -> (N, W, Q): thread j's port q is column j + W q."""
    n, L = x.shape
    out = np.zeros((n, w * q), F32)
    out[:, :L] = x
    return out.reshape(n, q, w).transpose(0, 2, 1)


def butterfly(x, op):
    """xor butterfly over the last axis: every lane ends with the same bits."""
    j = np.arange(x.shape[-1])
    o = x.shape[-1] // 2
    while o:
        x = op(x, x[..., j ^ o])
        o //= 2
    return x


def row_reduce(t, op):
    """(N, W) lane values -> (N,) the row's reduction, in the kernel's order."""
    n, w = t.shape
    if w <= WARP:
        return butterfly(t, op)[:, 0]
    per_warp = butterfly(t.reshape(n, w // WARP, WARP), op)[:, :, 0]
    return butterfly(per_warp, op)[:, 0]


def ports_sum(v):
    """(N, W, Q) -> (N, W): each thread's sum over its ports, in order."""
    t = v[..., 0]
    for q in range(1, v.shape[-1]):
        t = t + v[..., q]
    return t


def clip0(v, hi):
    return np.minimum(np.maximum(v, F32(0)), hi)


def water_level(z, a, m, c, iters: int = 20):
    """tau (N,) and need (N,) of float32 rows z, a, m (N, L), c (N,)."""
    L = z.shape[1]
    w, q = layout(L)
    z, a, m = (ports(np.asarray(t, F32), w, q) for t in (z, a, m))
    c = np.asarray(c, F32)
    row_sum = lambda v: row_reduce(ports_sum(v), np.add)
    s_box = row_sum(clip0(z, a) * m)
    need = s_box > c
    n_act = np.maximum(row_sum(m), F32(1))
    lo = np.maximum((s_box - c) / n_act, F32(0))
    zmax = np.where(m > 0, z, NEG).max(axis=-1)
    hi = np.maximum(row_reduce(zmax, np.maximum), lo)
    g = lambda tau: row_sum(clip0(z - tau[:, None, None], a) * m)
    for _ in range(iters):
        mid = F32(0.5) * (lo + hi)
        big = g(mid) > c
        lo, hi = np.where(big, mid, lo), np.where(big, hi, mid)
    glo, ghi = g(lo), g(hi)
    step = (glo - c) * (hi - lo) / np.maximum(glo - ghi, F32(1e-30))
    tau = np.minimum(np.maximum(lo + step, lo), hi)
    return np.where(need, tau, F32(0)), need


def project(z, a, m, c, iters: int = 20):
    """The rows projected as ``proj_bisect_kernel`` projects them (float32)."""
    z, a, m = (np.asarray(t, F32) for t in (z, a, m))
    tau, need = water_level(z, a, m, c, iters)
    return clip0(np.where(need[:, None], z - tau[:, None], z), a) * m


def case_inputs(rng, N: int, L: int):
    """The reference's projection-test distribution (z ~ 5 N(0, 1),
    a ~ U(0.1, 4), 80% of lanes masked in, c ~ U(0.3, 6)), with rows the
    capacity does not bind (every third), duplicated lanes, z = a lanes, a
    fully masked row, a row of zero capacity and a row of z = 0."""
    z = (rng.normal(0.0, 1.0, (N, L)) * 5.0).astype(F32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(F32)
    m = (rng.random((N, L)) < 0.8).astype(F32)
    c = rng.uniform(0.3, 6.0, N).astype(F32)
    c[::3] = 1e4
    z[1, 1::2] = z[1, 0:L - 1:2]
    a[1, 1::2] = a[1, 0:L - 1:2]
    z[2, 0] = a[2, 0]
    m[4] = 0.0
    c[5] = 0.0
    z[7] = 0.0
    return z, a, m, c
