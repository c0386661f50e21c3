"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840, MoE 384e top-8
(+1 shared expert). Assignment pins GQA (real K2 uses MLA — spec wins).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv=8,
        d_ff=0,
        vocab=163840,
        head_dim=112,
        n_experts=384,
        top_k=8,
        d_expert=2048,
        n_shared_experts=1,
        capacity_factor=1.25,
    )
)
