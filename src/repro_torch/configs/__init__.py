"""Assigned-architecture configs (public-literature specs).

The port's copy of ``repro.configs``: the same schema, registry and ten
configs, so ``names()`` matches the reference. ``shapes.py`` (the
dry-run's shape sets) is not ported yet.
"""
from repro_torch.configs.base import ArchConfig, get, names, reduced  # noqa: F401
