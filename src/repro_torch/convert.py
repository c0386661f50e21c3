"""State carried across from numpy or the reference package.

A test feeds both packages the same cluster spec, arrivals and initial
decision: it builds them once as numpy arrays (or reads the reference's
``ClusterSpec`` through ``np.asarray``) and hands them to the port here;
likewise a job lifecycle's mid-trace state (``lifecycle_state_from_reference``)
and an LM's parameters (``params_from_reference``). Nothing in this
module imports JAX.
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


def _leaf_tensor(x, dev: torch.device) -> torch.Tensor:
    """A numpy-like leaf as a tensor on ``dev`` in its own dtype: float32
    stays float32, bf16 stays bf16. A bf16 array (numpy dtype
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) goes
    through float32, which holds every bf16 value exactly."""
    arr = np.asarray(x)
    dtype = torch.bfloat16 if arr.dtype.name == "bfloat16" else None
    if arr.dtype.kind not in "iubf" or dtype is not None:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device=dev, dtype=dtype)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_reference(cfg, params_np, device: DeviceLike = None) -> dict:
    """The port's LM parameters from the reference's pytree (as numpy
    arrays, or anything ``np.asarray`` reads): every leaf in the reference
    leaf's own dtype on ``device`` (the MoE router and the SSM's ``A_log``,
    ``D`` and ``dt_bias`` are float32 in a bf16 config, as in the
    reference), and ``blocks``, whose leaves the reference stacks on a
    leading (n_layers,) axis, unstacked into a list of per-layer dicts.
    Matrices keep the reference's ``x @ W`` layout."""
    dev = resolve_device(device)
    out = {k: _tree(v, lambda a: _leaf_tensor(a, dev))
           for k, v in params_np.items() if k != "blocks"}
    stacked = _tree(params_np["blocks"], np.asarray)
    out["blocks"] = [_tree(stacked, lambda a, i=i: _leaf_tensor(a[i], dev))
                     for i in range(cfg.n_layers)]
    return out


def lifecycle_state_from_reference(obj, device: DeviceLike = None):
    """The port's ``sched.lifecycle.LifecycleState`` (G = 1) from the
    reference's ``LifecycleState``, or any object with its fields as
    numpy-readable arrays: float fields float32, counters int32, the slot
    counter a host int. Both packages can then step the same state."""
    from repro_torch.sched.lifecycle import LifecycleState

    dev = resolve_device(device)
    out = {}
    for f in LifecycleState.__dataclass_fields__:
        arr = np.array(getattr(obj, f))
        if f == "t":
            out[f] = int(arr.reshape(-1)[0])
            continue
        dtype = torch.int32 if arr.dtype.kind in "iu" else torch.float32
        # the per-configuration scalars become (1,), every other field gains G = 1
        arr = arr.reshape(1) if f in ("dropped", "rdropped", "eta") else arr[None]
        out[f] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    return LifecycleState(**out)
