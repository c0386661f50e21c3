"""Elastic rescale: the mesh a job manager's device grant becomes, and a
parameter tree moved between meshes at a checkpoint boundary.

Counterpart of ``repro.launch.elastic``. ``reshard`` places every leaf of
a tree with the auto-policy shardings of a mesh (``train/sharding.py``):
each leaf becomes a ``ShardedTensor``, one local copy of its slice per
mesh position, on that position's device (the reference's
``device_put`` with a ``NamedSharding``). ``rescale_checkpoint`` loads a
step written on any mesh, by either package, and places it so; ``gather``
puts a placed tree back whole.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.ckpt import checkpoint as C
from repro_torch.device import DeviceLike
from repro_torch.optim.adamw import tree_map
from repro_torch.train import sharding as shd
from repro_torch.train.meshctx import Mesh


def plan_mesh(n_devices: int, model_axis: Optional[int] = None) -> tuple[int, int]:
    """The largest power-of-two (data, model) mesh that fits ``n_devices``;
    the model axis is ``model_axis`` or min(16, devices), halved until it
    divides them."""
    n = 1 << (n_devices.bit_length() - 1)
    model = model_axis or min(16, n)
    while n % model:
        model //= 2
    return (n // model, model)


def reshard(tree: Any, new_mesh: Mesh) -> Any:
    """Every leaf of ``tree`` (tensors, or ShardedTensors placed on another
    mesh) placed with the parameter policy's specs on ``new_mesh``
    (``sharding.param_pspecs``)."""
    whole = gather(tree)
    return tree_map(lambda t, s: shd.ShardedTensor.place(t, shd.NamedSharding(new_mesh, s)),
                    whole, shd.param_pspecs(whole, new_mesh))


def gather(tree: Any, device: DeviceLike = None) -> Any:
    """Every ShardedTensor of ``tree`` whole on ``device`` (None: its first
    position's device); other leaves as they are."""
    return tree_map(lambda t: t.gather(device) if isinstance(t, shd.ShardedTensor) else t, tree)


def rescale_checkpoint(ckpt_dir: str, step: int, like: Any, new_mesh: Mesh) -> Any:
    """Step ``step`` of ``ckpt_dir``, written on any mesh by either
    package, in the structure and dtypes of ``like``, placed on
    ``new_mesh`` (loaded on the CPU, then each slice copied to its
    position's device)."""
    return reshard(C.load_checkpoint(ckpt_dir, step, like, "cpu"), new_mesh)
