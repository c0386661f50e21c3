"""Optimizer substrate: AdamW, its schedule, and gradient compression."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
)
