"""Mamba-2 SSD (state-space duality) block, chunked matmul formulation.

Counterpart of ``repro.models.ssm`` (Dao & Gu, arXiv:2405.21060):
intra-chunk attention-like matmuls and an inter-chunk state recurrence,
O(S) in the sequence length; decode carries an O(1) recurrent state (the
conv window and the SSM state).

The reference writes three of ``ssd_scan``'s contractions as
three-operand einsums. Here each is an explicit pair of products in an
order that never forms more than the output's elements times the chunk:
a naive order of "bcqn,bcqh,bcqhp->bchpn" would form a (B, nc, q, H, P, N)
tensor, 3.2 G elements at mamba2-780m's full width and 4096 tokens. The
reference's ``jax.lax.scan`` over chunks is a Python loop over them.

Dtypes follow the reference: ``A_log``, ``D`` and ``dt_bias`` are float32
whatever the parameter dtype; the full-sequence SSD runs in the input's
dtype (``dt`` and ``A`` cast to it); decode updates the state in float32
and stores it back in the cache's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import he_init, rms_norm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q) lower-triangular pairwise cumulative sums:
    out[i, j] = sum_{j < m <= i} x[m], -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int, h0: torch.Tensor = None):
    """x (B, S, H, P), dt (B, S, H) (softplus'd), A (H,) (negative), Bm and
    Cm (B, S, N) (one group), h0 (B, H, P, N) or None. Returns (y (B, S,
    H, P), the final state (B, H, P, N))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk

    xd = x * dt[..., None]                           # dt-weighted input
    dA = dt * A[None, None, :]                       # (B, S, H), <= 0
    xc = xd.reshape(Bsz, nc, chunk, H, P)
    dAc = dA.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    dA_cs = torch.cumsum(dAc, dim=2)                 # (B, nc, q, H)
    xh = xc.permute(0, 1, 3, 2, 4)                   # (B, nc, H, q, P)

    # 1) intra-chunk (diagonal blocks): (L * scores) @ x per head
    L = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))  # (B, nc, H, q, q)
    scores = Cc @ Bc.transpose(-1, -2)               # (B, nc, q, k)
    y_diag = (L * scores[:, :, None]) @ xh           # (B, nc, H, q, P)

    # 2) per-chunk states: decay-weighted sum of inputs, (x * decay)^T @ B
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (B, nc, q, H)
    xw = xh * decay_states.permute(0, 1, 3, 2)[..., None]        # (B, nc, H, q, P)
    states = xw.transpose(-1, -2) @ Bc[:, :, None]               # (B, nc, H, P, N)

    # 3) inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                  # (B, nc, H)
    h = x.new_zeros((Bsz, H, P, N)) if h0 is None else h0
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # (B, nc, H, P, N)

    # 4) state -> output within each chunk: (C @ h^T) * decay
    state_decay = torch.exp(dA_cs).permute(0, 1, 3, 2)[..., None]  # (B, nc, H, q, 1)
    y_off = (Cc[:, :, None] @ h_prev.transpose(-1, -2)) * state_decay
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
    return y, h


def init_mamba2(gen: torch.Generator, cfg, dtype) -> dict:
    """Mamba-2 mixer parameters; the conv runs over (x, B, C) concatenated."""
    d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = gen.device
    return {
        "in_proj": he_init(gen, (d, 2 * di + 2 * n + hh), d, dtype),
        "conv_w": he_init(gen, (cfg.conv_kernel, conv_dim), cfg.conv_kernel, dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, hh, dtype=torch.float32, device=dev)),
        "D": torch.ones(hh, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(hh, dtype=torch.float32, device=dev),
        "norm": torch.zeros(di, dtype=dtype, device=dev),
        "out_proj": he_init(gen, (di, d), di, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, D); w: (K, D); b: (D,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def _split_proj(zxbcdt: torch.Tensor, cfg):
    """in_proj's output -> (z (di), xbc (di + 2 n), dt (H))."""
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [di, di + 2 * n, cfg.ssm_heads], dim=-1)


def apply_mamba2(p: dict, x: torch.Tensor, cfg, return_state: bool = False):
    """Full-sequence Mamba-2 mixer. x: (B, S, d) -> (B, S, d); with
    ``return_state`` also the decode cache {"conv": the last K - 1 inputs
    of the conv (B, K - 1, di + 2 n), "state": the final SSD state (B, H,
    P, N)}, both in x's dtype."""
    B, S, _ = x.shape
    di, n, hh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc_raw, dt = _split_proj(x @ p["in_proj"], cfg)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])       # (B, S, H) float32
    A = -torch.exp(p["A_log"])                       # (H,)
    xh = xs.reshape(B, S, hh, hd)
    y, h_last = ssd_scan(xh, dt.to(x.dtype), A.to(x.dtype), Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = rms_norm(y.reshape(B, S, di) * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": xbc_raw[:, S - (cfg.conv_kernel - 1):, :], "state": h_last}
    return out


def init_mamba2_cache(cfg, batch: int, dtype, device) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                             dtype=dtype, device=device),
    }


def apply_mamba2_decode(p: dict, x: torch.Tensor, cache: dict, cfg):
    """Single-token decode. x: (B, 1, d); cache {"conv", "state"}. Returns
    (out (B, 1, d), the new cache): the state advanced in float32 and
    stored in the cache's dtype."""
    B = x.shape[0]
    di, n, hh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt = _split_proj(x @ p["in_proj"], cfg)
    win = torch.cat([cache["conv"], xbc], dim=1)     # (B, K, conv_dim)
    conv_out = torch.einsum("bkd,kd->bd", win, p["conv_w"]) + p["conv_b"]
    xs, Bm, Cm = torch.split(F.silu(conv_out), [di, n, n], dim=-1)   # (B, .)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H) float32
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                  # (B, H)
    xh = xs.reshape(B, hh, hd)
    dBx = (dt[:, :, None] * xh.float())[..., None] * Bm.float()[:, None, None, :]
    state = cache["state"].float() * dA[..., None, None] + dBx       # (B, H, P, N)
    y = (state @ Cm.float()[:, None, :, None])[..., 0]               # (B, H, P)
    y = y.to(x.dtype) + xh * p["D"].to(x.dtype)[None, :, None]
    y = rms_norm(y.reshape(B, 1, di) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": win[:, 1:], "state": state.to(cache["state"].dtype)}
