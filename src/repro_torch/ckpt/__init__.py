"""Checkpointing (counterpart of ``repro.ckpt``): atomic save and restore
of tensor trees, and the rotating manager."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    atomic_write_json,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt.manager import CheckpointManager  # noqa: F401
