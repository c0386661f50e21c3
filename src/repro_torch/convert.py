"""State carried across from numpy or the reference package.

A test feeds both packages the same cluster spec, arrivals and initial
decision: it builds them once as numpy arrays (or reads the reference's
``ClusterSpec`` through ``np.asarray``) and hands them to the port here.
Nothing in this module imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(x, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A copy of array-like ``x`` on ``device`` (float arrays keep their
    dtype unless ``dtype`` is given)."""
    arr = np.asarray(x)
    return torch.as_tensor(arr.copy(), dtype=dtype, device=resolve_device(device))


def spec_from_numpy(mask, a, c, alpha, beta, kinds,
                    device: DeviceLike = None) -> ClusterSpec:
    """A ``ClusterSpec`` from numpy arrays: float32 fields, int32 kinds."""
    dev = resolve_device(device)
    f32 = lambda t: tensor_from_numpy(np.asarray(t, np.float32), dev)
    return ClusterSpec(
        mask=f32(mask), a=f32(a), c=f32(c), alpha=f32(alpha), beta=f32(beta),
        kinds=tensor_from_numpy(np.asarray(kinds, np.int32), dev),
    )


def spec_from_reference(obj, device: DeviceLike = None) -> ClusterSpec:
    """A ``ClusterSpec`` from any object with ``mask``, ``a``, ``c``,
    ``alpha``, ``beta`` and ``kinds`` attributes (the reference's spec, a
    stacked spec, or a namespace of numpy arrays)."""
    return spec_from_numpy(
        *(np.asarray(getattr(obj, f)) for f in ClusterSpec.FIELDS), device=device
    )
