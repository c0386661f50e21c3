"""Production and host meshes (counterpart of ``repro.launch.mesh``).

Pure functions: building a mesh launches nothing on a device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.device import DeviceLike
from repro_torch.train.meshctx import Mesh, make_mesh


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Single pod: (data 16, model 16), 256 positions. Multi-pod: a
    leading 'pod' axis, (pod 2, data 16, model 16); 'pod' composes with
    'data' for batch and FSDP sharding (``train/sharding.py``).
    ``devices`` None takes the visible CUDA devices, and raises
    ``ValueError`` when they are fewer than the positions; on one card pass
    ``["cuda"] * 256`` (or 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(n: Optional[int] = None, axis: str = "data") -> Mesh:
    """A 1-D mesh of ``n`` positions on the CPU (``["cpu"] * n``; the
    tests' mesh). ``n`` None is torch's CPU device count, 1."""
    n = n or torch.cpu.device_count()
    return make_mesh((n,), (axis,), ["cpu"] * n)
