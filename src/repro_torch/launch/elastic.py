"""Elastic rescale: the mesh a job manager's device grant becomes.

Counterpart of ``repro.launch.elastic``'s ``plan_mesh``. Its ``reshard``
and ``rescale_checkpoint`` move a parameter tree between meshes through
``train/sharding.py``; they come with the multi-device modules (ROADMAP.md,
Queue 1, item 15h).
"""
from __future__ import annotations

from typing import Optional


def plan_mesh(n_devices: int, model_axis: Optional[int] = None) -> tuple[int, int]:
    """The largest power-of-two (data, model) mesh that fits ``n_devices``;
    the model axis is ``model_axis`` or min(16, devices), halved until it
    divides them."""
    n = 1 << (n_devices.bit_length() - 1)
    model = model_axis or min(16, n)
    while n % model:
        model //= 2
    return (n // model, model)
