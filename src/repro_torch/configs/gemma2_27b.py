"""Gemma2-27B — local+global alternating, logit softcaps [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; head_dim=128
explicit; 4096-token sliding window on local layers, attn softcap 50,
final logit softcap 30.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv=16,
        d_ff=36864,
        vocab=256000,
        head_dim=128,
        window=4096,
        window_pattern=2,
        attn_softcap=50.0,
        final_softcap=30.0,
    )
)
