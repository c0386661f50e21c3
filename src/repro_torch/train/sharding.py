"""Divisibility-driven auto-sharding policy (FSDP + TP), and tensors placed
by it.

Counterpart of ``repro.train.sharding``. Per tensor: the largest dim
divisible by the TP axis gets 'model'; the largest remaining dim divisible
by the combined DP axes gets ('pod', 'data') (or 'data' on one pod). One
rule covers all ten configs, awkward head counts (28, 25) included: where
head dims do not divide, the policy falls through to d_model or the
sequence.

Two layouts differ from the reference's. The port keeps ``blocks`` as a
list of per-layer dicts, with no leading (n_layers,) axis, so a block
leaf's spec is the reference's with its leading None (the scan dim, never
sharded) dropped; the expert weights' branch, (layers, E, a, b) there, is
(E, a, b) here. Decode caches stay stacked, as in both packages, and keep
the reference's rule whole.

``NamedSharding`` says which slice of a tensor each mesh position holds
(``shard_shape``, ``indices``, as ``jax.sharding.NamedSharding``'s
``shard_shape`` and ``devices_indices_map``); ``ShardedTensor`` holds one
local tensor per position, on the position's device.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.device import DeviceLike
from repro_torch.optim.adamw import tree_map
from repro_torch.train.meshctx import Mesh, P, PartitionSpec, axis_size, dp_axes

__all__ = ["P", "PartitionSpec", "dp_axes", "auto_pspec", "param_pspecs", "cache_pspecs",
           "batch_pspecs", "shardings", "NamedSharding", "ShardedTensor"]


def auto_pspec(shape: Sequence[int], mesh, *, skip_dims: Sequence[int] = (),
               batch_dim: Optional[int] = None) -> PartitionSpec:
    """Assign mesh axes to tensor dims by size and divisibility.

    ``batch_dim``: force this dim onto the DP axes (inputs, caches); if it
    is not divisible by the full DP product, fall back to its largest
    divisible suffix ('data' alone, or nothing).
    """
    assign: list = [None] * len(shape)
    used_axes: set = set()

    def try_assign(dim: int, axes) -> bool:
        size = axis_size(mesh, axes)
        if shape[dim] % size == 0 and shape[dim] >= size and size > 1:
            assign[dim] = axes if isinstance(axes, str) else tuple(axes)
            used_axes.update([axes] if isinstance(axes, str) else axes)
            return True
        return False

    dps = dp_axes(mesh)
    if batch_dim is not None:
        # the full DP product first, then suffix sub-products, then nothing
        for cand in (dps,) + tuple(dps[i:] for i in range(1, len(dps))):
            if try_assign(batch_dim, cand):
                break

    dims = sorted((d for d in range(len(shape)) if d not in skip_dims and assign[d] is None),
                  key=lambda d: -shape[d])
    # TP first (largest dim), then FSDP over the remaining DP axes
    for d in dims:
        if "model" not in used_axes and try_assign(d, "model"):
            break
    rem_dp = tuple(a for a in dps if a not in used_axes)
    if rem_dp:
        for d in dims:
            if assign[d] is None and try_assign(d, rem_dp):
                break
    return PartitionSpec(*assign)


_EXPERT_LEAVES = ("gate", "up", "down")


def param_pspecs(shapes: Any, mesh) -> Any:
    """PartitionSpecs for a parameter tree (leaves with a ``shape``: meta
    tensors, tensors, arrays). Block leaves (under ``blocks``, one dict a
    layer) are sharded on every dim: the reference skips only its scan
    dim, which the port does not have."""

    def leaf(keys, s):
        shape = tuple(s.shape)
        # the reference's rank: block leaves carry its (n_layers,) dim
        ref_rank = len(shape) + ("blocks" in keys)
        # routed expert weights: experts on 'model' (the EP layout, no
        # per-layer expert resharding), their first matrix dim on DP
        if "moe" in keys and keys[-1] in _EXPERT_LEAVES and ref_rank == 4:
            dp = dp_axes(mesh)
            e_ok = shape[0] % mesh.shape["model"] == 0
            a_ok = shape[1] % axis_size(mesh, dp) == 0
            return PartitionSpec("model" if e_ok else None, dp if a_ok else None, None)
        return auto_pspec(shape, mesh)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, keys) for v in tree]
        return leaf(keys, tree)

    return walk(shapes, [])


def cache_pspecs(shapes: Any, mesh) -> Any:
    """Decode caches, stacked: (layers, batch, ...) -> batch on DP, the
    layer dim never sharded, the rest auto."""

    def leaf(s):
        if len(s.shape) >= 3:
            return auto_pspec(tuple(s.shape), mesh, skip_dims=(0,), batch_dim=1)
        return PartitionSpec(*([None] * len(s.shape)))

    return tree_map(leaf, shapes)


def batch_pspecs(shapes: Any, mesh, pure_dp: bool = False) -> Any:
    """Input batches: dim 0 is the global batch. ``pure_dp`` plans spread
    the batch over every mesh axis (model included)."""

    def leaf(s):
        shape = tuple(s.shape)
        rest = tuple(range(1, len(shape)))
        if pure_dp:
            all_axes = tuple(mesh.axis_names)
            if shape[0] % axis_size(mesh, all_axes) == 0:
                return PartitionSpec(all_axes, *([None] * (len(shape) - 1)))
        return auto_pspec(shape, mesh, batch_dim=0, skip_dims=rest)

    return tree_map(leaf, shapes)


class NamedSharding:
    """A PartitionSpec on a mesh: which slice of a tensor each position
    holds."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def _dims(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than a {ndim}-D tensor has dims")
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        return [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in entries]

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Each position's slice shape; ``ValueError`` where a dim does not
        divide by its axes' product."""
        out = []
        for n, axes in zip(shape, self._dims(len(shape))):
            parts = axis_size(self.mesh, axes)
            if n % parts:
                raise ValueError(f"a dim of {n} split {parts} ways by {self.spec} "
                                 f"(shape {tuple(shape)})")
            out.append(n // parts)
        return tuple(out)

    def indices(self, shape: Sequence[int]) -> dict:
        """{mesh coordinate: a tuple of slices, one a dim}; an unsplit dim
        is ``slice(None)``. A dim split over several axes takes its index
        from their coordinates row major, the first slowest."""
        local = self.shard_shape(shape)
        dims = self._dims(len(shape))
        out = {}
        for coord in self.mesh.coords():
            at = dict(zip(self.mesh.axis_names, coord))
            idx = []
            for n, axes in zip(local, dims):
                if axis_size(self.mesh, axes) == 1:
                    idx.append(slice(None))
                    continue
                k = 0
                for a in axes:
                    k = k * self.mesh.shape[a] + at[a]
                idx.append(slice(k * n, (k + 1) * n))
            out[coord] = tuple(idx)
        return out

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


def shardings(pspecs: Any, mesh: Mesh) -> Any:
    """A NamedSharding for every PartitionSpec of ``pspecs``."""
    return tree_map(lambda p: NamedSharding(mesh, p), pspecs)


class ShardedTensor:
    """A tensor split by a NamedSharding: one local tensor (its own copy)
    per mesh position, on that position's device. ``gather`` puts it back
    whole; ``np.asarray`` (the checkpoint writer's path) gathers on the
    CPU."""

    def __init__(self, sharding: NamedSharding, shape: Sequence[int], dtype: torch.dtype,
                 shards: dict):
        self.sharding, self.shape, self.dtype, self.shards = \
            sharding, tuple(shape), dtype, shards

    @classmethod
    def place(cls, t: torch.Tensor, sharding: NamedSharding) -> "ShardedTensor":
        t = torch.as_tensor(t)
        shards = {coord: t[idx].to(device=sharding.mesh.devices[coord], copy=True)
                  for coord, idx in sharding.indices(tuple(t.shape)).items()}
        return cls(sharding, t.shape, t.dtype, shards)

    def gather(self, device: DeviceLike = None) -> torch.Tensor:
        """The whole tensor on ``device`` (None: the first position's)."""
        first = next(iter(self.shards.values()))
        dev = first.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for coord, idx in self.sharding.indices(self.shape).items():
            out[idx] = self.shards[coord].to(dev)
        return out

    def __array__(self, dtype=None, copy=None):
        t = self.gather("cpu")
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self) -> str:
        return f"ShardedTensor({list(self.shape)}, {self.dtype}, {self.sharding})"
