"""Mamba2-780m — attention-free SSD [arXiv:2405.21060; unverified].

48L d_model=1536, ssm_state=128, d_inner=2*d, headdim=64, chunk=256.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv=0,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=256,
        conv_kernel=4,
    )
)
