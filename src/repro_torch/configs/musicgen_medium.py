"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (kv=24 => MHA) d_ff=6144 vocab=2048. The EnCodec codec
and the 4-codebook delay pattern are frontend stubs: input_specs() provides a
single already-flattened token stream (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv=24,
        d_ff=6144,
        vocab=2048,
        head_dim=64,
        n_codebooks=4,
    )
)
