"""Hymba-1.5B — parallel attention+SSM heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504, ssm_state=16. Every block runs
attention and a Mamba2 mixer in parallel on the same input, outputs fused by
learned per-channel norms. Sliding-window attention everywhere (1024); the
SSM branch provides global context (meta-tokens omitted; DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv=5,
        d_ff=5504,
        vocab=32001,
        head_dim=64,
        window=1024,
        window_pattern=0,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=256,
        conv_kernel=4,
    )
)
