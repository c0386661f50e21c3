"""Common layers: RMSNorm, RoPE and M-RoPE, SwiGLU MLP, softcap, inits.

Counterpart of ``repro.models.layers``. Inits draw from an explicit ``torch.Generator`` on the
device the parameter lives on, in float32, and are cast once to the
parameter dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, scaled by (1 + w), returned in x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def he_init(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """N(0, 2 / fan_in) drawn in float32 on ``gen``'s device, cast to dtype."""
    scale = (2.0 / max(fan_in, 1)) ** 0.5
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


# ---------------------------------------------------------------- RoPE -----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate (B, S, H, hd) by per-token positions (B, S): split halves, not
    interleaved, in float32, returned in x's dtype."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * inv  # (B, S, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rotate(x, sin, cos)


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """The split-halves rotation of (B, S, H, hd) by (B, S, 1, hd/2) angles,
    in float32, returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: (B, S, 3) positions (t, h, w); the hd/2 frequencies
    fall into ``sections`` bands in order, each rotated by its own
    position stream, with ``apply_rope``'s split-halves rotation."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    inv = rope_freqs(hd, theta, x.device)
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(list(sections), device=x.device))
    ang = positions.float()[..., sec_id] * inv  # (B, S, hd/2)
    return _rotate(x, torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :])


# ---------------------------------------------------------------- MLP ------
def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "gate": he_init(gen, (d_model, d_ff), d_model, dtype),
        "up": he_init(gen, (d_model, d_ff), d_model, dtype),
        "down": he_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def swiglu_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["gate"])
    return (g * (x @ p["up"])) @ p["down"]
