"""DBRX — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        d_ff=0,
        vocab=100352,
        head_dim=128,
        n_experts=16,
        top_k=4,
        d_expert=10752,
        capacity_factor=1.25,
    )
)
