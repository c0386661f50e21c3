"""Euclidean projection onto Y (paper eq. 32, Alg. 1 fast projection).

Counterpart of ``repro.core.projection``. The projection decomposes per
(instance r, resource k) cell: project z_{(:,r)}^k onto

    { yhat : 0 <= yhat_l <= a_l^k  (l in L_r),  sum_l yhat_l <= c_r^k }.

Water-filling form: yhat_l = clip(z_l - tau, 0, a_l) with tau = 0 when
sum_l clip(z_l, 0, a_l) <= c, otherwise the tau > 0 with
g(tau) = sum_l clip(z_l - tau, 0, a_l) = c.

These are the plain PyTorch versions. The CUDA sortscan kernel
(``kernels.sortscan.proj_sortscan``) computes the same function on the
card; ``project_exact_np`` is the float64 numpy oracle both are held to.
``project_bisection`` is the reference's bisection A/B baseline.

``project_spec_rows`` is the entry the job lifecycle and the size-aware
baselines project through: it packs an (L, R, K) decision into the
kernel's (R*K, L) rows and calls ``kernels.ops.proj_sortscan``, the CUDA
kernel on the card and ``project_rows_sorted`` on the CPU, as
``core.regret.offline_optimum`` does. ``fill_rows_to_capacity`` projects
through the same wrapper.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.graph import ClusterSpec

_NEG = -1e30

# Lane count at which project_rows_sorted switches from the all-pairs
# O(L^2) breakpoint evaluation to the one-sort prefix-sum sweep. The value
# is the reference's XLA:CPU crossover, kept so both packages take the same
# branch at the same width; the torch crossover is not measured yet.
SORTSCAN_MIN_L = 192


def _clip(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, a) = min(max(x, 0), a), as jnp.clip evaluates it."""
    return torch.minimum(torch.clamp_min(x, 0.0), a)


def _finish_water_level(zf, af, m, cf, lo, box, need):
    """Shared closed-form tail of both breakpoint sweeps: given the last
    breakpoint ``lo`` with g(lo) >= c, recompute g(lo) and the segment
    slope exactly in one O(L) pass, solve for tau, and water-fill."""
    glo = (_clip(zf - lo, af) * m).sum(-1, keepdim=True)
    # slope just right of lo: lanes interior on (lo, next breakpoint)
    n = (m * (zf - af <= lo) * (zf > lo)).sum(-1, keepdim=True)
    # n = 0 means g is flat at exactly c past lo (ties / c = 0): tau = lo.
    tau = torch.where(n > 0.5, lo + (glo - cf) / torch.clamp_min(n, 1.0), lo)
    tau = torch.clamp_min(tau, 0.0)
    proj = _clip(zf - tau, af) * m
    return torch.where(need, proj, box)


def project_rows_allpairs(z, a, mask, c):
    """Exact row projection via all-pairs breakpoint evaluation, O(L^2).

    g is convex, non-increasing and piecewise linear with breakpoints
    {z_l - a_l, z_l}; it is evaluated at all 2L breakpoints at once, the
    last breakpoint ``lo`` with g(lo) >= c selects the segment, and
    ``_finish_water_level`` solves it in closed form.
    z, a, mask: (N, L); c: (N,).
    """
    m = mask.to(torch.float32)
    zf, af = z.to(torch.float32), a.to(torch.float32)
    cf = c.to(torch.float32)[:, None]

    box = _clip(zf, af) * m
    need = box.sum(-1, keepdim=True) > cf

    v = torch.cat([zf - af, zf], dim=-1)                     # (N, 2L)
    gv = (_clip(zf[:, None, :] - v[:, :, None], af[:, None, :])
          * m[:, None, :]).sum(-1)                           # (N, 2L)
    lo = torch.where(gv >= cf, v, _NEG).amax(-1, keepdim=True)
    return _finish_water_level(zf, af, m, cf, lo, box, need).to(z.dtype)


def project_rows_sortscan(z, a, mask, c):
    """Exact row projection via one sort + prefix sums, O(L log L).

    Sort the breakpoints with their slope deltas (+m at z - a, -m at z),
    prefix-sum the deltas to the active-lane count per segment, walk g down
    segment by segment, and pick ``lo`` as above. The prefix sums only
    SELECT the segment; ``_finish_water_level`` recomputes g(lo) directly.
    The sort is stable, so tied breakpoints keep their input order.
    """
    m = mask.to(torch.float32)
    zf, af = z.to(torch.float32), a.to(torch.float32)
    cf = c.to(torch.float32)[:, None]

    box = _clip(zf, af) * m
    need = box.sum(-1, keepdim=True) > cf

    v = torch.cat([zf - af, zf], dim=-1)
    d = torch.cat([m, -m], dim=-1)
    vs, order = torch.sort(v, dim=-1, stable=True)
    ds = torch.gather(d, -1, order)
    n_seg = torch.cumsum(ds, dim=-1)
    g0 = (_clip(zf - vs[:, :1], af) * m).sum(-1, keepdim=True)
    seg = n_seg[:, :-1] * (vs[:, 1:] - vs[:, :-1])
    gv = g0 - torch.cat([torch.zeros_like(g0), torch.cumsum(seg, dim=-1)], dim=-1)
    lo = torch.where(gv >= cf, vs, _NEG).amax(-1, keepdim=True)
    return _finish_water_level(zf, af, m, cf, lo, box, need).to(z.dtype)


def project_rows_sorted(z, a, mask, c):
    """Exact projection of each row of z onto {0 <= y <= a, sum(y*m) <= c}.

    z, a, mask: (N, L); c: (N,). Narrow rows (L < SORTSCAN_MIN_L) take the
    all-pairs evaluation, wide rows the sort + prefix-sum sweep.
    """
    if z.shape[-1] < SORTSCAN_MIN_L:
        return project_rows_allpairs(z, a, mask, c)
    return project_rows_sortscan(z, a, mask, c)


def fill_rows_to_capacity(z, a, mask, c):
    """Euclidean projection of each row onto the capacity-SATURATING face
    {0 <= y <= a, sum(y*m) = min(c, sum(a*m))}: y = clip(z - tau, 0, a)
    with a signed level tau, so the row exhausts its capacity (or every
    lane caps out).

    The feasibility solve of work-conserving size-aware policies. For
    z >= 0 (heSRPT's ideal points theta * c) the signed level reduces to
    the non-negative one by an offset: z + delta with delta = max(a m)
    saturates every lane's box clamp, so the exact sweep's tau' = tau +
    delta >= 0 is exact, and clip is shift-equivariant. Projects through
    ``kernels.sortscan.proj_sortscan`` (the CUDA kernel on CUDA tensors,
    ``project_rows_sorted`` on the CPU). z, a, mask: (N, L); c: (N,).
    Masked-out lanes stay structurally zero.
    """
    from repro_torch.kernels import sortscan  # kernels.ref imports this module

    delta = (a.to(torch.float32) * mask.to(torch.float32)).amax(-1, keepdim=True)
    shifted = (z.to(torch.float32) + delta).contiguous()
    return sortscan.proj_sortscan(shifted, a, mask, c).to(z.dtype)


def fill_to_capacity(z, a, c, mask):
    """Cluster-level ``fill_rows_to_capacity``: z (L, R, K), a (L, K),
    c (R, K), mask (L, R), the packing of ``project_sorted``."""
    L, R, K = z.shape
    a_rows, m_rows = _cell_rows(a, mask, R, K, L)
    rows = z.permute(1, 2, 0).reshape(R * K, L).contiguous()
    out = fill_rows_to_capacity(rows, a_rows.contiguous(), m_rows.contiguous(),
                                c.reshape(-1).contiguous())
    return out.reshape(R, K, L).permute(2, 0, 1)


def project_spec_rows(spec: ClusterSpec, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                      *, operands=None) -> torch.Tensor:
    """Pi_Y(z) for z (.., L, R, K) against capacities ``c`` (.., R, K),
    ``spec.c`` when None: one ``kernels.ops.proj_sortscan`` over the packed
    (.., R*K, L) rows, so a stacked spec (leading G) projects all its
    configurations in one launch. ``operands`` carries
    ``ops.pack_spec_operands(spec)`` so a loop over slots packs the static
    rows once."""
    from repro_torch.kernels import ops  # kernels.ops imports this module

    L, R, K = spec.L, spec.R, spec.K
    with spans.span("repro_torch.ops.project"):
        a_rows, mask_rows, _ = ops.pack_spec_operands(spec) if operands is None else operands
        c = spec.c if c is None else c
        z_rows = ops.pack_rows(z).reshape(-1, L)
        out = ops.proj_sortscan(z_rows, a_rows, mask_rows, c.reshape(-1).contiguous())
        return ops.unpack_rows(out.reshape(*z.shape[:-3], R * K, L), L, R, K)


def _cell_rows(spec_a, spec_mask, R, K, L):
    a_rows = spec_a.T[None].expand(R, K, L).reshape(R * K, L)
    m_rows = spec_mask.T[:, None].expand(R, K, L).reshape(R * K, L)
    return a_rows, m_rows


def project_sorted(z, a, c, mask):
    """Exact projection of z (L, R, K) onto Y: a (L, K), c (R, K),
    mask (L, R). Cells are packed to (R*K, L) rows, projected, unpacked."""
    L, R, K = z.shape
    a_rows, m_rows = _cell_rows(a, mask, R, K, L)
    rows = z.permute(1, 2, 0).reshape(R * K, L)
    out = project_rows_sorted(rows, a_rows, m_rows, c.reshape(-1))
    return out.reshape(R, K, L).permute(2, 0, 1)


def project_bisection(z, a, c, mask, iters: int = 64):
    """Projection of z (L, R, K) onto Y by fixed-iteration bisection on
    tau over [0, max_l z_l], vectorised over every (r, k) cell; the A/B
    baseline of the exact sweep. a (L, K), c (R, K), mask (L, R); ``iters``
    halvings (64 reach float32 precision)."""
    m = mask[:, :, None]
    box = _clip(z, a[:, None, :]) * m                 # the tau = 0 candidate
    need = box.sum(0) > c                             # (R, K) capacity binds
    hi = torch.clamp_min(torch.where(m > 0, z, _NEG).amax(0), 0.0)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        g = (_clip(z - mid[None], a[:, None, :]) * m).sum(0)
        too_big = g > c
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    tau = 0.5 * (lo + hi)
    proj = _clip(z - tau[None], a[:, None, :]) * m
    return torch.where(need[None], proj, box)


PROJECT_METHODS = ("sorted", "bisect")


def project(spec: ClusterSpec, z: torch.Tensor, iters: int = 64,
            method: str = "sorted") -> torch.Tensor:
    """Pi_Y(z) (eq. 32). ``method="sorted"`` (the default) is the exact
    breakpoint sweep; ``method="bisect"`` the fixed-iteration bisection
    (``iters`` applies to it only), kept for A/B comparison."""
    if method == "sorted":
        return project_sorted(z, spec.a, spec.c, spec.mask)
    if method == "bisect":
        return project_bisection(z, spec.a, spec.c, spec.mask, iters=iters)
    raise ValueError(f"method must be one of {PROJECT_METHODS}, got {method!r}")


def project_exact_np(z: np.ndarray, a: np.ndarray, c: float) -> np.ndarray:
    """Exact 1-cell projection via breakpoint sweep in float64 (the test
    oracle; a copy of ``repro.core.projection.project_exact_np``).
    z, a: (L,); c scalar."""
    z = np.asarray(z, np.float64)
    a = np.asarray(a, np.float64)
    box = np.clip(z, 0.0, a)
    if box.sum() <= c + 1e-12:
        return box
    bps = np.unique(np.concatenate([z, z - a, [0.0]]))
    bps = bps[bps >= 0.0]
    g = lambda tau: np.clip(z - tau, 0.0, a).sum()
    vals = np.array([g(t) for t in bps])
    idx = np.searchsorted(-vals, -c)  # vals descending
    if idx == 0:
        lo_t, hi_t = 0.0, bps[0]
        lo_v, hi_v = g(0.0), vals[0]
    elif idx >= len(bps):
        lo_t = bps[-1]
        lo_v = vals[-1]
        hi_t, hi_v = lo_t + a.max() + 1.0, g(lo_t + a.max() + 1.0)
    else:
        lo_t, hi_t = bps[idx - 1], bps[idx]
        lo_v, hi_v = vals[idx - 1], vals[idx]
    if abs(hi_v - lo_v) < 1e-15:
        tau = lo_t
    else:  # g is linear on the segment
        tau = lo_t + (lo_v - c) * (hi_t - lo_t) / (lo_v - hi_v)
    return np.clip(z - tau, 0.0, a)


def project_alg1_np(z: np.ndarray, a: np.ndarray, c: float) -> np.ndarray:
    """Paper Algorithm 1 (steps 7-30) for one (r, k) cell, verbatim (a copy
    of ``repro.core.projection.project_alg1_np``).

    Sorts z descending, iterates the B1 (at cap) / B2 (at zero) / B3
    (interior) partition with rho from eq. 35 until no illegal allocation
    remains.
    """
    z = np.asarray(z, np.float64)
    a = np.asarray(a, np.float64)
    n = len(z)
    order = np.argsort(-z)  # step 7: sort descending
    zs, as_ = z[order], a[order]
    b1: set[int] = set()
    yhat = np.zeros(n)
    outer = 0
    while True:  # outer while (step 9): one cap moves to B1 per pass
        outer += 1
        if outer > n + 2:
            raise RuntimeError("Alg1 failed to converge")
        # steps 10-13: B2 resets to empty, B3 to the non-capped ports
        b2: set[int] = set()
        b3 = set(range(n)) - b1
        while True:  # inner repeat (steps 18-30)
            if b3:
                rho = 2.0 * (sum(zs[i] for i in b3) - c + sum(as_[i] for i in b1)) / len(b3)
                rho = max(rho, 0.0)  # eq. 35
            else:
                rho = 0.0
            s_rk: set[int] = set()
            for i in range(n):  # step 21
                if i in b1:
                    yhat[i] = as_[i]
                elif i in b2:
                    yhat[i] = 0.0
                elif i in b3:
                    yhat[i] = zs[i] - rho / 2.0
                    if yhat[i] < 0.0:
                        # z sorted => all later interior ports also illegal
                        s_rk = {j for j in range(i, n) if j in b3}
                        break
            if not s_rk:
                break
            for j in s_rk:  # step 29: B2 <- B2 u S, B3 <- B3 \ S
                yhat[j] = 0.0
            b2 |= s_rk
            b3 -= s_rk
        # step 15: the first interior port over its cap moves to B1, one a
        # pass (the paper's rule when caps are uniform)
        viol = [i for i in sorted(b3) if yhat[i] > as_[i] + 1e-12]
        if not viol:
            break
        b1.add(viol[0])  # step 16
    out = np.zeros(n)
    out[order] = np.clip(yhat, 0.0, as_)
    return out


def project_cluster_np(spec: ClusterSpec, z: np.ndarray, method: str = "exact") -> np.ndarray:
    """The full projection by the per-(r, k) numpy oracle, cell by cell:
    ``project_exact_np`` ("exact") or ``project_alg1_np`` (any other)."""
    z = np.asarray(z, np.float64)
    mask = spec.mask.cpu().numpy()
    a = spec.a.cpu().numpy()
    c = spec.c.cpu().numpy()
    fn = project_exact_np if method == "exact" else project_alg1_np
    out = np.zeros_like(z)
    for r in range(spec.R):
        ports = np.nonzero(mask[:, r])[0]
        if len(ports) == 0:
            continue
        for k in range(spec.K):
            out[ports, r, k] = fn(z[ports, r, k], a[ports, k], float(c[r, k]))
    return out
