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
from repro_torch.kernels import autotune


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


def proj_rows_bisect(z, a, mask, c, iters: int = autotune.DEFAULT_BISECT_ITERS):
    """The seeded bisection of ``kernels.proj_bisect`` in float32: bracket
    lo = max((sum box - c) / max(sum m, 1), 0), hi = max(max_{m>0} z, lo),
    ``iters`` halvings on g(mid) > c, then the secant step clipped to the
    bracket. The plain version of the bisect kernel and of the fused step's
    bisect branch."""
    m = mask.to(torch.float32)
    zf, af = z.to(torch.float32), a.to(torch.float32)
    cf = c.to(torch.float32)[:, None]
    g = lambda tau: (_proj._clip(zf - tau, af) * m).sum(-1, keepdim=True)

    box = _proj._clip(zf, af) * m
    s_box = box.sum(-1, keepdim=True)
    need = s_box > cf
    n_act = torch.clamp_min(m.sum(-1, keepdim=True), 1.0)
    lo = torch.clamp_min((s_box - cf) / n_act, 0.0)
    hi = torch.maximum(torch.where(m > 0, zf, _proj._NEG).amax(-1, keepdim=True), lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = g(mid) > cf
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    glo, ghi = g(lo), g(hi)
    tau = lo + (glo - cf) * (hi - lo) / torch.clamp_min(glo - ghi, 1e-30)
    tau = torch.where(need, torch.minimum(torch.maximum(tau, lo), hi), 0.0)
    return torch.where(need, _proj._clip(zf - tau, af) * m, box).to(z.dtype)


def proj_rows_ref(z, a, mask, c, iters: int = 64):
    """Direct bisection over rows from the bracket [0, max z], ``iters``
    halvings and the midpoint: an independent re-implementation (the
    reference's ``ref.proj_rows_ref``)."""
    m = mask
    box = _proj._clip(z, a) * m
    need = box.sum(1) > c
    hi = torch.clamp_min(torch.where(m > 0, z, _proj._NEG).amax(1), 0.0)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        big = (_proj._clip(z - mid[:, None], a) * m).sum(1) > c
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    tau = 0.5 * (lo + hi)
    proj = _proj._clip(z - tau[:, None], a) * m
    return torch.where(need[:, None], proj, box)


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


OGA_PROJECTIONS = ("sorted", "bisect")


def oga_step_ref(y, a, mask, x, kstar, scal, proj: str = "sorted",
                 iters: int = autotune.DEFAULT_BISECT_ITERS):
    """Packed-row OGA update: gradient (eq. 30) -> ascent -> projection.

    y, a, mask, x, kstar: (N, L); ``scal`` (N, NUM_SCAL) with the columns of
    ``kernels.oga_step.SCAL_COLUMNS`` (alpha, beta, c, kind, eta). The
    gradient covers all seven utility kinds through ``utilities.util_grad``.
    ``proj="sorted"`` projects exactly (the kernel's sortscan method),
    ``proj="bisect"`` by the seeded bisection with ``iters`` halvings (its
    bisect method).
    """
    if proj not in OGA_PROJECTIONS:
        raise ValueError(f"proj must be one of {OGA_PROJECTIONS}, got {proj!r}")
    alpha, beta, c, kind, eta = scal.unbind(1)
    g = U.util_grad(kind[:, None].to(torch.int32), alpha[:, None], y * mask)
    g = g - beta[:, None] * kstar
    z = y + eta[:, None] * x * g * mask
    if proj == "sorted":
        return proj_rows_sorted(z, a, mask, c)
    return proj_rows_bisect(z, a, mask, c, iters)


# score of a masked (query, key) pair, as in the reference attention
ATTN_MASKED = -1e30


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain attention computes in: float64 for float64 inputs
    (``torch.autograd.gradcheck``), float32 for every other."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _visible(qpos: torch.Tensor, kpos: torch.Tensor, window) -> torch.Tensor:
    """(n, S) keys a query sees: kpos <= qpos and, for window > 0,
    qpos - kpos < window."""
    m = kpos[None, :] <= qpos[:, None]
    if window is not None and window > 0:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def flash_attention_ref(q, k, v, *, window=None, softcap=None, q_block: int = 256,
                        return_lse: bool = False):
    """Causal GQA attention, blockwise over query blocks (the port of
    ``repro.models.attention.attention``, the flash kernel's oracle).

    q: (B, S, H, hd); k, v: (B, S, G, hd), H = G * rep. Scores in float32
    (float64 for float64 inputs), scaled by hd^-0.5, softcapped, then the
    causal mask and, when ``window`` > 0, the window (qpos - kpos) <
    window, with masked scores at -1e30; softmax over all S keys; the
    output in q's dtype. Only a (q_block, S) score tile per head is alive at
    once. A ragged last block (S not a multiple of ``q_block``) is taken as
    it is. With ``return_lse`` it returns (o, lse): lse (B, H, S) is each
    row's log-sum-exp of its visible scores, in the computing type (what
    both forward kernels write for the backward).
    """
    B, S, H, hd = q.shape
    G = k.shape[2]
    rep = H // G
    bq = min(q_block, S)
    scale = hd ** -0.5
    acc = _acc_dtype(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    kpos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=acc, device=q.device) if return_lse else None
    for q0 in range(0, S, bq):
        qi = q[:, q0:q0 + bq].to(acc)
        n = qi.shape[1]
        qpos = q0 + torch.arange(n, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qi.reshape(B, n, G, rep, hd), kf) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~_visible(qpos, kpos, window), ATTN_MASKED)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
        out[:, q0:q0 + n] = o.reshape(B, n, H, hd).to(q.dtype)
        if return_lse:
            lse[:, :, q0:q0 + n] = torch.logsumexp(s, dim=-1).reshape(B, H, n)
    return (out, lse) if return_lse else out


def _bwd_blocks(q, k, v, o, lse, do, window, softcap, q_block):
    """The backward's query blocks: for each, (q0, n, qi, doi, kf, vf, s,
    t, lse_i, d_row) in the computing type, the block's raw scaled scores
    s (B, G, rep, n, S), their tanh t (None without a softcap), its lse and
    D = rowsum(do o), both (B, G, rep, n, 1)."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    rep = H // G
    bq = min(q_block, S)
    acc = _acc_dtype(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    for q0 in range(0, S, bq):
        qi = q[:, q0:q0 + bq].to(acc)
        n = qi.shape[1]
        qi = qi.reshape(B, n, G, rep, hd)
        oi = o[:, q0:q0 + n].to(acc).reshape(B, n, G, rep, hd)
        doi = do[:, q0:q0 + n].to(acc).reshape(B, n, G, rep, hd)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qi, kf) * hd ** -0.5
        t = None if softcap is None else torch.tanh(s / softcap)
        lse_i = lse[:, :, q0:q0 + n].to(acc).reshape(B, G, rep, n, 1)
        d_row = (doi * oi).sum(-1).permute(0, 2, 3, 1)[..., None]    # (B, G, rep, n, 1)
        yield q0, n, qi, doi, kf, vf, s, t, lse_i, d_row


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, window=None, softcap=None,
                            q_block: int = 256):
    """The gradient of ``flash_attention_ref``: (dq, dk, dv) of the loss
    whose gradient in the output ``o`` is ``do``, with ``lse`` (B, H, S)
    the forward's row log-sum-exp (the plain version of the backward
    kernels in ``csrc/flash_attention_bwd.cu``).

    Blockwise over query blocks, step by step the formulas the kernels
    implement, in float32 (float64 for float64 inputs): D = rowsum(do *
    o); P = exp(s_c - lse) (masked scores at -1e30, so P is exactly 0
    there); dV = P^T dO; dP = dO V^T; dS = P (dP - D), times the softcap's
    derivative 1 - (s_c / c)^2; dQ = dS K hd^-0.5 and dK = dS^T Q hd^-0.5,
    dK and dV summed over the rep query heads of each KV head. Each
    gradient comes back in its input's dtype.
    """
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    acc = _acc_dtype(q.dtype)
    kpos = torch.arange(S, device=q.device)
    dq = torch.empty(q.shape, dtype=acc, device=q.device)
    dk = torch.zeros(k.shape, dtype=acc, device=q.device)
    dv = torch.zeros(v.shape, dtype=acc, device=q.device)
    for q0, n, qi, doi, kf, vf, s, t, lse_i, d_row in _bwd_blocks(q, k, v, o, lse, do, window,
                                                                 softcap, q_block):
        qpos = q0 + torch.arange(n, device=q.device)
        if softcap is not None:
            s = softcap * t
        p = torch.exp(s.masked_fill(~_visible(qpos, kpos, window), ATTN_MASKED) - lse_i)
        dv += torch.einsum("bgrqk,bqgrd->bkgd", p, doi)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", doi, vf)
        ds = p * (dp - d_row)
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dq[:, q0:q0 + n] = (torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale).reshape(
            B, n, H, hd)
        dk += torch.einsum("bgrqk,bqgrd->bkgd", ds, qi) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


LOG2E = 1.4426950408889634


def flash_attention_bwd_emulation(q, k, v, o, lse, do, *, window=None, softcap=None,
                                  q_block: int = 256):
    """The bf16 backward kernels' arithmetic in plain torch (the tests hold
    the kernels' bar with it; nothing on the main path calls it): float32
    scores of the (bf16) inputs; u = tanh(s hd^-0.5 / c) with a softcap c,
    else s hd^-0.5; p = 2^(c' u - lse log2 e) with c' = c log2 e, or log2 e;
    dS = p (dP - D) (1 - u^2 with a softcap); P^T and dS^T rounded once to
    bf16 before the products dV = P^T dO, dK = dS^T Q and dQ = dS K, which
    sum in float32; dK and dQ scaled by hd^-0.5 after the sums, every
    gradient rounded once to the inputs' dtype.
    """
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    kpos = torch.arange(S, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    c = softcap * LOG2E if softcap is not None else LOG2E
    for q0, n, qi, doi, kf, vf, s, t, lse_i, d_row in _bwd_blocks(q, k, v, o, lse, do, window,
                                                                 softcap, q_block):
        qpos = q0 + torch.arange(n, device=q.device)
        u = t if softcap is not None else s
        p = torch.exp2(u * c - lse_i * LOG2E)
        p = p.masked_fill(~_visible(qpos, kpos, window), 0.0)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", doi, vf)
        ds = p * (dp - d_row)
        if softcap is not None:
            ds = ds * (1.0 - u * u)
        p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
        dv += torch.einsum("bgrqk,bqgrd->bkgd", p16, doi)
        dq[:, q0:q0 + n] = (torch.einsum("bgrqk,bkgd->bqgrd", ds16, kf) * scale).reshape(
            B, n, H, hd)
        dk += torch.einsum("bgrqk,bqgrd->bkgd", ds16, qi)
    dk = dk * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
