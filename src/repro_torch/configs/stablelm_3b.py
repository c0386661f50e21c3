"""StableLM-3B — dense MHA (kv=32) [hf:stabilityai/stablelm-2; unverified].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv=32,
        d_ff=6912,
        vocab=50304,
        head_dim=80,
    )
)
