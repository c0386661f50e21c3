"""StarCoder2-15B — dense, GQA kv=4, RoPE [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv=4,
        d_ff=24576,
        vocab=49152,
        head_dim=128,
        rope_theta=100000.0,
    )
)
