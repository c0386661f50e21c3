"""Causal GQA attention for prefill and training, and one-token decode over
a KV cache.

Counterpart of ``repro.models.attention``. ``attention`` is always causal
and takes a per-layer ``window`` (<= 0 or None: global) and a logit
softcap; on a CUDA tensor it runs the hand-written flash kernel
(``kernels.ops.flash_attention``), on a CPU tensor the plain blockwise
version (``kernels.ref.flash_attention_ref``), which computes the same
function. Where a gradient is wanted (grad mode on and an input that
requires one) it runs ``FlashAttention``, whose backward is the
hand-written backward kernels on the card (``ops.flash_attention_bwd``)
and their plain version on the CPU (``ref.flash_attention_bwd_ref``): the
reference takes that gradient by autodiff of its jnp attention. On a CUDA
tensor neither pass falls back to torch ops. Meta tensors (the dry run's)
go to the wrappers too, which give the kernels' output shapes and launch
nothing. ``decode_attention`` is plain torch on either device, as the
reference's is jnp outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.layers import softcap


def _forward(q, k, v, window, attn_softcap, return_lse=False):
    if q.device.type in ("cuda", "meta"):
        return ops.flash_attention(q, k, v, window=window, softcap=attn_softcap,
                                   return_lse=return_lse)
    return ref.flash_attention_ref(q, k, v, window=window, softcap=attn_softcap,
                                   return_lse=return_lse)


class FlashAttention(torch.autograd.Function):
    """Causal attention with its gradient: forward as ``attention``, which
    also writes each row's log-sum-exp (the same launch on the card);
    backward (dq, dk, dv) from q, k, v, the saved output o and that lse, by
    the backward kernels on a CUDA tensor and ``ref.flash_attention_bwd_ref``
    on a CPU tensor (which takes float64 too, for ``gradcheck``)."""

    @staticmethod
    def forward(ctx, q, k, v, window, attn_softcap):
        o, lse = _forward(q, k, v, window, attn_softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.attn_softcap = window, attn_softcap
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        w, cap = ctx.window, ctx.attn_softcap
        if q.device.type in ("cuda", "meta"):
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), window=w,
                                                 softcap=cap)
        else:
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=w,
                                                     softcap=cap)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: Optional[int] = None,
              attn_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, G, hd) with H = G * rep. Returns like q.

    The CPU branch calls the plain version itself, not the wrapper: the
    wrapper refuses on every device what the kernels do not take (head
    dims outside ``autotune.FLASH_HEAD_DIMS``, the multiples of 16 from 16
    to 128: every config's, the reduced configs' 16 among them), and the
    plain version takes any. Without a gradient to take, only the forward
    runs, as in serving.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, window, attn_softcap)
    return _forward(q, k, v, window, attn_softcap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, key_positions: torch.Tensor, *,
                     window: Optional[int] = None,
                     attn_softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode. q: (B, 1, H, hd); caches: (B, S, G, hd).

    ``key_positions`` (B, S) holds each cache slot's absolute token position
    per row (empty slots a large sentinel); ``pos`` (B,) is each row's
    current position, its slot already written. A key is seen when
    kpos <= pos and, for window > 0, (pos - kpos) < window.
    """
    B, _, H, hd = q.shape
    G = k_cache.shape[2]
    rep = H // G
    qg = q.reshape(B, G, rep, hd).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float()) * hd ** -0.5
    s = softcap(s, attn_softcap)
    m = key_positions <= pos[:, None]  # (B, S)
    if window is not None and window > 0:
        m &= (pos[:, None] - key_positions) < window
    s = s.masked_fill(~m[:, None, None], ref.ATTN_MASKED)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
