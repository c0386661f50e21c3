"""Qwen2-VL-7B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. Modality frontend is
a stub: input_specs() provides 256 precomputed patch embeddings (PATCH_DIM
features) that the model projects and prepends; M-RoPE sections (t,h,w) over
head_dim/2 = 64 frequencies.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv=4,
        d_ff=18944,
        vocab=152064,
        head_dim=128,
        mrope_sections=(16, 24, 24),
        n_patches=256,
    )
)
