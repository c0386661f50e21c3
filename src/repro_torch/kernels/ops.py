"""Dispatch around the kernels: the spec-level OGA backend switch, its
grid-flattened batch form, and the (L, R, K) <-> (N = R*K, L) row layout.

Counterpart of ``repro.kernels.ops``. Row n of the packed layout is cell
(r, k) and its lanes are the ports; packing is a permute + reshape, so the
round trip is exact. ``backend="fused"`` runs the fused OGA step
(``kernels.oga_step.oga_step_fused``: the CUDA kernel on the card, its
plain version on the CPU), its row block resolved from ``kernels.autotune``
on CUDA tensors and never on the CPU; ``backend="reference"`` runs
gradient, ascent and projection as separate spec-level torch passes.
``flash_attention`` and ``flash_attention_bwd`` dispatch causal attention
and its gradient to their kernels' wrappers.
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.core import projection as _projection
from repro_torch.core import reward as _reward
from repro_torch.kernels import autotune as _at
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import oga_step as _og
from repro_torch.kernels import proj_bisect as _pb
from repro_torch.kernels import sortscan as _ss

OGA_BACKENDS = ("auto", "fused", "reference")
# host time from resolving a launch's tiling to the wrapper's return (the
# operand checks, the launch itself, its counters)
LAUNCH_SPAN = "repro_torch.launch"
UPDATE_SPAN = "repro_torch.ops.oga_update"


def resolve_oga_backend(backend: str = "auto") -> str:
    """"auto" -> "fused"."""
    if backend not in OGA_BACKENDS:
        raise ValueError(f"backend must be one of {OGA_BACKENDS}, got {backend!r}")
    return "fused" if backend == "auto" else backend


# ------------------------------------------------------------- row layout --
def pack_rows(t: torch.Tensor) -> torch.Tensor:
    """(.., L, R, K) decisions -> (.., R*K, L) contiguous kernel rows (a
    copy unless ``t`` is itself a view of such rows, as ``unpack_rows``
    returns)."""
    L, R, K = t.shape[-3:]
    return t.movedim(-3, -1).reshape(*t.shape[:-3], R * K, L).contiguous()


def unpack_rows(rows: torch.Tensor, L: int, R: int, K: int) -> torch.Tensor:
    """(.., R*K, L) kernel rows -> (.., L, R, K) decisions (a view)."""
    return rows.reshape(*rows.shape[:-2], R, K, L).movedim(-1, -3)


def pack_spec_operands(spec):
    """Static fused-kernel operands of a spec: (a_rows, mask_rows,
    scal_static), i.e. per-row caps and adjacency (N, L) and the leading
    (N, NUM_SCAL - 1) scalar columns in ``oga_step.SCAL_COLUMNS`` order.
    Built once per trajectory; eta is appended per step. A stacked spec
    (leading G) gives its operands with the grid axis flattened into the
    rows: (G*R*K, L) and (G*R*K, NUM_SCAL - 1)."""
    L, R, K = spec.L, spec.R, spec.K
    lead = tuple(spec.mask.shape[:-2])
    rows = lambda t: t.reshape(-1, L).contiguous()
    a_rows = rows(spec.a.transpose(-1, -2)[..., None, :, :].expand(*lead, R, K, L))
    mask_rows = rows(spec.mask.transpose(-1, -2)[..., :, None, :].expand(*lead, R, K, L))
    per_cell = lambda t: t.expand(*lead, R, K).reshape(-1)
    scal_static = _og.pack_scal_static(
        spec.alpha.reshape(-1),
        per_cell(spec.beta[..., None, :]),
        spec.c.reshape(-1),
        per_cell(spec.kinds[..., None, :]).to(spec.a.dtype),
    )
    return a_rows, mask_rows, scal_static


# the reference's name for the stacked case, which pack_spec_operands covers
pack_spec_operands_batch = pack_spec_operands


def kstar_index(spec, y: torch.Tensor) -> torch.Tensor:
    """k*_l = argmax_k beta_k sum_r y (eq. 27) (.., L), first index on ties
    as in reward_grad."""
    s = (y * spec.mask[..., None]).sum(-2)                              # (.., L, K)
    return torch.argmax(spec.beta[..., None, :] * s, dim=-1)


def _kstar_rows(spec, y: torch.Tensor, kstar=None) -> torch.Tensor:
    """1{k = k*_l} broadcast to (.., R*K, L) kernel rows; k* from the local
    y unless ``kstar`` ((.., L) indices) is given."""
    L, R, K = spec.L, spec.R, spec.K
    kstar = kstar_index(spec, y) if kstar is None else kstar
    onehot = (kstar[..., None] == torch.arange(K, device=kstar.device)).to(y.dtype)  # (.., L, K)
    lead = tuple(y.shape[:-3])
    return onehot.transpose(-1, -2)[..., None, :, :].expand(*lead, R, K, L).reshape(
        *lead, R * K, L).contiguous()


def _tiling(kernel: str, t: torch.Tensor, tiling, **pin) -> _at.KernelConfig:
    """The launch config of ``kernel`` over the rows of ``t``: an explicit
    ``tiling`` as given; otherwise, on CUDA tensors, the autotune cache's
    entry for the shape (``DEFAULT_CONFIG`` on a miss) with the fields in
    ``pin`` overriding it. On any other device ``resolve`` is never called
    and the wrappers run their plain versions."""
    if tiling is not None:
        return tiling
    if t.device.type != "cuda":
        return _at.DEFAULT_CONFIG._replace(**pin)
    return _at.resolve(kernel, *t.shape, device=t.device)._replace(**pin)


def _dispatch_fused(y_rows, a_rows, mask_rows, x_rows, kstar_rows, scal, tiling=None):
    """The fused update of packed rows. Its row block is ``tiling``'s or,
    when None, the autotune cache's for the packed shape. The method is
    always the exact sortscan, whatever the cache or the pin says: cache
    state changes speed, never values. The bisect A/B goes through
    ``oga_step_fused(tiling=...)``."""
    with spans.span(LAUNCH_SPAN):
        cfg = _tiling("oga_step", y_rows, tiling)
        return _og.oga_step_fused(y_rows, a_rows, mask_rows, x_rows, kstar_rows, scal,
                                  method="sortscan", row_block=cfg.row_block)


def oga_update_spec(spec, y, x, eta, *, backend: str = "auto", operands=None,
                    tiling=None, kstar=None):
    """One OGA slot update y -> y(t+1) at the (L, R, K) spec level.

    backend:
      "reference" -- gradient (eq. 30), ascent and the exact spec-level
                     projection as separate torch passes.
      "fused"     -- one ``oga_step_fused`` over the (R*K, L) rows: the
                     CUDA kernel on the card, its plain version on the CPU.
      "auto"      -- "fused".
    ``operands`` carries ``pack_spec_operands(spec)`` so a loop over slots
    does not rebuild the static rows every step. ``tiling`` (an
    ``autotune.KernelConfig``) pins the kernel's row block; by default it
    comes from the autotune cache. ``kstar`` ((L,) indices) replaces the
    k* of eq. 27 that the local y gives: a shard of the instances takes
    the k* of the global quota (core.distributed).
    """
    backend = resolve_oga_backend(backend)
    if backend == "reference":
        if kstar is not None:
            raise ValueError("an explicit kstar runs on the fused backend only")
        g = _reward.reward_grad(spec, x, y)
        return _projection.project(spec, y + eta * g)

    L, R, K = spec.L, spec.R, spec.K
    with spans.span(UPDATE_SPAN):
        a_rows, mask_rows, scal_static = (
            pack_spec_operands(spec) if operands is None else operands
        )
        x_rows = x.to(y.dtype)[None].expand(R * K, L).contiguous()
        rows = _dispatch_fused(
            pack_rows(y), a_rows, mask_rows, x_rows, _kstar_rows(spec, y, kstar),
            _og.with_eta(scal_static, eta), tiling,
        )
        return unpack_rows(rows, L, R, K)


def oga_update_batch(spec, y, x, eta, *, operands=None, tiling=None):
    """One fused OGA slot update for a stacked grid of G configs, with the
    grid axis flattened into the rows: N = G*R*K, one kernel launch.

    spec: stacked, every field leading (G,); y (G, L, R, K); x (G, L);
    eta (G,). ``tiling`` as in ``oga_update_spec``. Returns y(t+1)
    (G, L, R, K).
    """
    G, L, R, K = y.shape
    N = R * K
    with spans.span(UPDATE_SPAN):
        a_rows, mask_rows, scal_static = (
            pack_spec_operands_batch(spec) if operands is None else operands
        )
        y_rows = pack_rows(y).reshape(G * N, L)
        kstar_rows = _kstar_rows(spec, y).reshape(G * N, L)
        x_rows = x.to(y.dtype)[:, None, :].expand(G, N, L).reshape(G * N, L).contiguous()
        eta_rows = eta.to(scal_static.dtype)[:, None].expand(G, N).reshape(G * N)
        rows = _dispatch_fused(
            y_rows, a_rows, mask_rows, x_rows, kstar_rows,
            _og.with_eta(scal_static, eta_rows), tiling,
        )
        return unpack_rows(rows.reshape(G, N, L), L, R, K)


# ------------------------------------------------------- kernel dispatchers --
def oga_step_fused(y, a, mask, x, kstar, scal, *, tiling=None):
    """The fused kernel over packed rows. An explicit ``tiling`` is run as
    pinned, bisect included: the A/B entry. Otherwise the cache contributes
    the row block only and the method is the exact sortscan."""
    cfg = _tiling("oga_step", y, tiling, method="sortscan", iters=0)
    return _og.oga_step_fused(y, a, mask, x, kstar, scal, method=cfg.method,
                              row_block=cfg.row_block, iters=cfg.iters or None)


def proj_bisect(z, a, mask, c, *, tiling=None):
    """The bisection projection. The cache contributes the row block only
    (both methods take the same row blocks); the iteration count stays the
    kernel's default unless ``tiling`` pins it, so cache state never
    changes values."""
    cfg = _tiling("proj", z, tiling, iters=0)
    return _pb.proj_bisect(z, a, mask, c, row_block=cfg.row_block, iters=cfg.iters or None)


def proj_sortscan(z, a, mask, c, *, tiling=None):
    """The exact sortscan projection, its row block from ``tiling`` or the
    autotune cache."""
    with spans.span(LAUNCH_SPAN):
        cfg = _tiling("proj", z, tiling)
        return _ss.proj_sortscan(z, a, mask, c, row_block=cfg.row_block)


def flash_attention(q, k, v, *, window=None, softcap=None, return_lse=False):
    """Causal GQA attention: the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors (``kernels.flash_attention``); with
    ``return_lse``, (o, lse)."""
    return _fa.flash_attention(q, k, v, window=window, softcap=softcap, return_lse=return_lse)


def flash_attention_bwd(q, k, v, o, lse, do, *, window=None, softcap=None):
    """The gradient (dq, dk, dv) of ``flash_attention`` from its output and
    row log-sum-exp: the three backward kernels on CUDA tensors, their
    plain version on CPU tensors (``kernels.flash_attention.flash_attention_bwd``)."""
    return _fa.flash_attention_bwd(q, k, v, o, lse, do, window=window, softcap=softcap)
