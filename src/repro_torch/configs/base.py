"""Architecture config schema + registry (a copy of the reference's data)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One LM-family architecture (assigned-pool spec)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attn-free
    n_kv: int             # GQA kv heads
    d_ff: int             # dense MLP hidden (or 0)
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding window size
    window_pattern: int = 1               # every Nth layer is GLOBAL (1 = all global)
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    mrope_sections: Optional[Sequence[int]] = None  # qwen2-vl M-RoPE

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # frontend stubs
    n_patches: int = 0      # vlm: precomputed patch embeddings prepended
    n_codebooks: int = 0    # audio: EnCodec codebooks (stubbed to 1 stream)

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # training memory knobs
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs)
    logits_chunk: int = 0   # 0 = unchunked loss; >0 = chunked CE over seq
    attn_unroll: bool = False  # unroll the q-block scan (cost-analysis passes)

    # parallelism plan (hillclimb knobs; defaults = paper-faithful baseline)
    pure_dp: bool = False           # batch over data AND model axes (small archs)
    attn_head_parallel: bool = False  # head-sharded attention (vs SP blockwise)
    mlp_ep: bool = False  # shard_map MLP: bf16 seq-AG + psum_scatter vs f32 ARs
    kv_cache_quant: bool = False  # int8 KV cache (per-token-head scales)

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def has_attn(self) -> bool:
        return self.n_heads > 0 and self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def scales_embedding(self) -> bool:
        """Whether the token embedding is multiplied by sqrt(d_model): the
        Gemma-2 family's rule (repro/models/model.py:79 and :165 test the
        name the same way)."""
        return self.name.startswith("gemma2")

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.n_layers
        p = 2 * self.vocab * d  # embed + unembed (untied)
        per_layer = 0
        if self.has_attn:
            q = self.n_heads * self.hd
            kv = self.n_kv * self.hd
            per_layer += d * (q + 2 * kv) + q * d
        if self.has_ssm:
            conv_dim = self.d_inner + 2 * self.ssm_state
            per_layer += d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads)
            per_layer += self.conv_kernel * conv_dim + self.d_inner * d
        if self.n_experts > 0:
            per_layer += d * self.n_experts  # router
            per_layer += 3 * d * self.d_expert * (self.n_experts + self.n_shared_experts)
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff  # SwiGLU gate/up/down
        per_layer += 2 * d  # norms
        return p + L * per_layer

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.n_params
        d, L = self.d_model, self.n_layers
        inactive = 3 * d * self.d_expert * (self.n_experts - self.top_k)
        return self.n_params - L * inactive


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def names() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        dbrx_132b,
        gemma2_27b,
        hymba_1_5b,
        kimi_k2_1t_a32b,
        mamba2_780m,
        musicgen_medium,
        qwen2_72b,
        qwen2_vl_7b,
        stablelm_3b,
        starcoder2_15b,
    )


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv=min(cfg.n_kv, 2) if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16 if cfg.has_attn else None,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.n_experts else 0,
        d_expert=32 if cfg.n_experts else 0,
        capacity_factor=8.0,  # no drops -> decode == forward in smoke tests
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.has_ssm else 64,
        ssm_chunk=16,
        window=min(cfg.window, 16) if cfg.window else None,
        n_patches=8 if cfg.n_patches else 0,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        param_dtype="float32",
        compute_dtype="float32",
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
