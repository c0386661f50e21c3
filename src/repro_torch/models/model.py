"""LM wrapper: embeddings -> blocks -> norm -> logits, and the serving entry
points ``prefill`` and ``serve_step``.

Counterpart of ``repro.models.model`` for every family (``loss_fn`` and
``param_shapes`` are not ported yet). Parameters are a plain dict:
``embed`` (vocab, d), ``blocks`` (a list of per-layer dicts),
``final_norm`` (d,), ``unembed`` (d, vocab) and, for vlm, ``patch_proj``
(PATCH_DIM, d), matrices in the reference's ``x @ W`` layout.

Front ends, as in the reference: vlm consumes precomputed patch
embeddings ``batch["patch_embeds"]`` (B, n_patches, PATCH_DIM), projected
and prepended to the text, with M-RoPE's (t, h, w) positions; audio
consumes EnCodec token ids as a dense model does (the codec is outside the
model). ``serve_step`` gives a vlm decode token the position (pos, pos,
pos), as the reference does, which is not where prefill's text positions
(i - n_patches + grid) would continue (ROADMAP Queue 3, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_init, he_init, rms_norm, softcap

PATCH_DIM = 1024  # the stub front end's feature width (vlm)


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (None: the CUDA card; raises without one).

    Every tensor is drawn on the device in float32 and cast to the
    parameter dtype one at a time, so the largest transient is one float32
    matrix (gemma2-27b: the 256000 x 4608 embedding, 4.7 GB) and no host
    copy of the model is made. The MoE router and the SSM's ``A_log``,
    ``D`` and ``dt_bias`` are float32 whatever the parameter dtype, as in
    the reference.
    """
    tf.check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = param_dtype(cfg)
    params = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "blocks": [tf.init_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
        "unembed": he_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, dtype),
    }
    if cfg.family == "vlm":
        params["patch_proj"] = he_init(gen, (PATCH_DIM, cfg.d_model), PATCH_DIM, dtype)
    return params


def _mrope_positions(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """(B, S, 3) stub M-RoPE ids: patch i gets (0, i // grid, i % grid) on
    a sqrt(n_patches) grid; text advances all three streams together from
    grid (qwen2-vl semantics)."""
    n_p = cfg.n_patches
    grid = max(int(n_p ** 0.5), 1)
    i = torch.arange(S, device=device)
    is_patch = i < n_p
    text = i - n_p + grid
    pos = torch.stack([torch.where(is_patch, 0, text),
                       torch.where(is_patch, i // grid, text),
                       torch.where(is_patch, i % grid, text)], dim=-1)
    return pos.expand(B, S, 3)


def _positions(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """(B, S) token positions 0..S-1, or M-RoPE's (B, S, 3)."""
    if cfg.mrope_sections is not None:
        return _mrope_positions(cfg, B, S, device)
    return torch.arange(S, device=device).expand(B, S)


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    dtype = compute_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
    if cfg.scales_embedding:
        # sqrt(d) rounded to the compute dtype first, as the reference does
        # (bf16: sqrt(4608) = 67.88 becomes 68.0)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=x.device)
    return x


def embed_inputs(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch["tokens"] (B, S) -> (B, S, d) in the compute dtype; vlm
    prepends its projected ``batch["patch_embeds"]`` (B, n_patches,
    PATCH_DIM)."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        dtype = compute_dtype(cfg)
        pe = batch["patch_embeds"].to(dtype) @ params["patch_proj"].to(dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    logits = (x @ params["unembed"].to(x.dtype)).float()
    return softcap(logits, cfg.final_softcap)


def forward(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """-> logits (B, S, vocab) in float32."""
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    x = tf.stack_forward(params["blocks"], cfg, x, _positions(cfg, B, S, x.device))
    return _logits(params, cfg, rms_norm(x, params["final_norm"], cfg.norm_eps))


def prefill(params, cfg: ArchConfig, batch: dict):
    """Forward over the prompt; returns (last-token logits (B, vocab) in
    float32, the cache: with attention {"k", "v": (n_layers, B, S, G, hd),
    "kpos": (n_layers, B, S) int32}, with int8 "k", "v" and float32
    "k_scale", "v_scale" (n_layers, B, S, G) under ``cfg.kv_cache_quant``;
    with an SSM {"conv", "state"}). Only the last position's logits are
    formed."""
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    x, caches = tf.stack_forward(params["blocks"], cfg, x, _positions(cfg, B, S, x.device),
                                 collect=True)
    if cfg.has_attn:
        caches["kpos"] = torch.arange(S, dtype=torch.int32, device=x.device).expand(
            cfg.n_layers, B, S).contiguous()
    x = rms_norm(x[:, -1, :], params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), caches


def serve_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, pos):
    """One decode step. tokens: (B, 1) int; pos: an int or (B,) per-row
    absolute positions (continuous batching). Returns (logits (B, vocab)
    in float32, the cache), the cache updated in place. M-RoPE gives the
    token the position (pos, pos, pos), as the reference does."""
    x = _embed(params, cfg, tokens)
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(B)
    positions = pos[:, None, None].expand(B, 1, 3) if cfg.mrope_sections is not None \
        else pos[:, None]
    x, cache = tf.stack_decode(params["blocks"], cfg, x, cache, pos, positions)
    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), cache
