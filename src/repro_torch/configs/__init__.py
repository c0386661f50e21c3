"""Assigned-architecture configs (public-literature specs).

The port's copy of ``repro.configs``: the same schema, registry and ten
configs, so ``names()`` matches the reference, and ``shapes.py``, the
assigned input shapes (``train_step.input_specs`` reads them).
"""
from repro_torch.configs.base import ArchConfig, get, names, reduced  # noqa: F401
