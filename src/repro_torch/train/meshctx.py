"""Device meshes in one process, and the mesh context for in-model
sharding hints.

Counterpart of ``repro.train.meshctx``. A ``Mesh`` names its axes and
holds an array of ``torch.device`` of the mesh's shape; a position may
name the same device as another (four shards of one card are
``["cuda"] * 4``), so a mesh of any shape runs on one card when the
caller asks for it. The multi-device modules (``models.moe``'s
expert-parallel layers, ``models.pipeline``, ``launch.elastic``) run
their shards as a loop over the mesh's positions in a fixed order.

Model code calls ``constrain(x, "data", None, "model")``-style hints, as
the reference's does. In the reference they become
``with_sharding_constraint``: XLA places ``x`` so. In one process a hint
places nothing, so ``constrain`` returns ``x`` itself. Under an active
mesh it still resolves the hint by the reference's rule ("data" is the
pod and data axes, "batch" every axis; a dimension whose axis product is
1 or does not divide it is left unsharded) into the ``PartitionSpec``
the reference would place with, ``resolve_spec``'s. That validates the
hint (an axis the mesh lacks, or more entries than dimensions, raises).
Its output moves no value: a model run under a mesh is the run without
one, bit for bit, wherever the hints are all it adds.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (unsharded), a mesh axis name,
    or a tuple of names (the dimension split over their product, the
    first slowest). A tuple of one name is that name and an empty tuple
    is None, as in the reference's ``jax.sharding.PartitionSpec``, so the
    two compare equal entry by entry."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over an array of devices: ``shape`` maps each axis name
    to its size in order, ``devices`` is an object array of
    ``torch.device`` of that shape (as ``jax.sharding.Mesh``'s)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"a {devs.ndim}-D device array for the axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis names {axis_names}")
        self.devices = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            self.devices[idx] = torch.device(devs[idx])
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devs.shape))

    def coords(self) -> Iterator[tuple[int, ...]]:
        """Every position, in row-major order (the last axis fastest)."""
        return np.ndindex(self.devices.shape)

    def device(self, **coord: int) -> torch.device:
        """The device at the named axes' coordinates (0 on any other)."""
        unknown = set(coord) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh {self.axis_names}")
        return self.devices[tuple(coord.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        names = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={names})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices``, row
    major (the counterpart of ``jax.make_mesh``). ``devices`` None means
    every visible CUDA device. Raises ``ValueError`` when there are fewer
    devices than positions: nothing is folded onto fewer devices unless
    the caller names a device more than once."""
    shape = tuple(int(n) for n in shape)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(f"a {shape} mesh needs {n} devices; {len(devices)} given "
                         f"(name a device several times to fold the mesh onto it)")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names)


_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes, pod first."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    """The product of the sizes of ``axes``: None, an axis name or names."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _resolve(axis, mesh: Mesh):
    if axis == "data":
        return dp_axes(mesh)
    if axis == "batch":  # pure-DP plans: every axis carries batch
        return tuple(mesh.axis_names)
    return axis


def resolve_spec(shape: Sequence[int], spec: Sequence, mesh: Mesh) -> PartitionSpec:
    """The PartitionSpec the reference's ``constrain(x, *spec)`` places
    ``x`` of ``shape`` with on ``mesh``. Raises ``ValueError`` for more
    entries than dimensions or an axis the mesh lacks."""
    if len(spec) > len(shape):
        raise ValueError(f"{len(spec)} sharding entries for a {len(shape)}-D tensor")
    resolved = []
    for dim, axis in enumerate(spec):
        axes = _resolve(axis, mesh)
        names = (axes,) if isinstance(axes, str) else axes or ()
        missing = [a for a in names if a not in mesh.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh {mesh.axis_names}")
        size = axis_size(mesh, axes)
        if axis is None or shape[dim] % size != 0 or size == 1:
            resolved.append(None)
        else:
            resolved.append(axes)
    return PartitionSpec(*resolved)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` itself. Under an active mesh the hint is resolved, and so
    validated, first; one process places nothing."""
    mesh = _MESH.get()
    if mesh is not None:
        resolve_spec(tuple(x.shape), spec, mesh)
    return x


def dp_positions(mesh: Mesh) -> list[dict]:
    """One coordinate dict over the data-parallel axes per data shard, in
    the order the reference's ``P(dp, ...)`` splits a batch (row major,
    pod slowest)."""
    axes = dp_axes(mesh)
    return [dict(zip(axes, c)) for c in itertools.product(*(range(mesh.shape[a]) for a in axes))]
