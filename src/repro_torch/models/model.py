"""LM wrapper: embeddings -> blocks -> norm -> logits, and the serving entry
points ``prefill`` and ``serve_step``.

Counterpart of ``repro.models.model`` for the dense family (text only: the
vlm and audio front ends and ``loss_fn`` are not ported yet). Parameters
are a plain dict: ``embed`` (vocab, d), ``blocks`` (a list of per-layer
dicts), ``final_norm`` (d,) and ``unembed`` (d, vocab), matrices in the
reference's ``x @ W`` layout.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_init, he_init, rms_norm, softcap


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
    copy of the model is made.
    """
    tf.check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = param_dtype(cfg)
    return {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "blocks": [tf.init_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
        "unembed": he_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, dtype),
    }


def _positions(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """(B, S) token positions 0..S-1 (text only)."""
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
    """batch["tokens"] (B, S) -> (B, S, d) in the compute dtype."""
    return _embed(params, cfg, batch["tokens"])


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
    float32, the cache {"k", "v": (n_layers, B, S, G, hd), "kpos":
    (n_layers, B, S) int32}, with int8 "k", "v" and float32 "k_scale",
    "v_scale" (n_layers, B, S, G) under ``cfg.kv_cache_quant``). Only the
    last position's logits are formed."""
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    x, caches = tf.stack_forward(params["blocks"], cfg, x, _positions(cfg, B, S, x.device),
                                 collect=True)
    caches["kpos"] = torch.arange(S, dtype=torch.int32, device=x.device).expand(
        cfg.n_layers, B, S).contiguous()
    x = rms_norm(x[:, -1, :], params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), caches


def serve_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, pos):
    """One decode step. tokens: (B, 1) int; pos: an int or (B,) per-row
    absolute positions (continuous batching). Returns (logits (B, vocab)
    in float32, the cache), the cache updated in place."""
    x = _embed(params, cfg, tokens)
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(B)
    x, cache = tf.stack_decode(params["blocks"], cfg, x, cache, pos, pos[:, None])
    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), cache
