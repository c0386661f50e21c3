"""Atomic checkpoints of trees of tensors: an npz payload and a JSON
manifest.

Counterpart of ``repro.ckpt.checkpoint``, file for file: the same names
(``step_%08d.npz`` / ``.json``, staging ``.tmp.*``), the same manifest
keys (``step``, ``names``, ``dtypes``, ``shapes``, ``sha256``, and the
caller's ``extra``) and the same leaf names (the reference's key paths:
``['w']``, ``[0]``, ``.field``), so a step either package writes is
verified and read by the other.

Write protocol (crash-ordered): serialize the payload to
``<dir>/.tmp.<step>.npz``, fsync, ``os.replace`` into place, fsync the
directory; only then write and publish the manifest the same way. The
manifest is the commit record: it is published strictly after the payload
is durable, so every crash window leaves a state ``verify_checkpoint``
reads as "not written" (a payload without its manifest, or a stale
same-step manifest whose checksum no longer matches). Orphaned ``.tmp.*``
files of a crash mid-write are swept by the manager on init.

A tree is nested dicts (keys in sorted order), lists, tuples and
namedtuples, with tensors, numpy arrays or numbers as leaves; ``None`` is
an empty subtree. Restore places every leaf on ``device`` (None: the CUDA
card), the counterpart of the reference's ``shardings``.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _children(tree: Any):
    """(key-path step, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten_with_names(tree: Any, prefix: str = ""):
    """(names, leaves) in the reference's flattening order."""
    if tree is None:
        return [], []
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    names, leaves = [], []
    for step, child in kids:
        n, l = _flatten_with_names(child, prefix + step)
        names += n
        leaves += l
    return names, leaves


def _unflatten(like: Any, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    values = [_unflatten(child, leaves) for _, child in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as a host array; a bf16 tensor (numpy has no bf16) as float32,
    which holds every bf16 value exactly and is cast back on restore."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_dir(path: str) -> None:
    """Make a rename durable: fsync the containing directory (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish(tmp: str, final: str, directory: str) -> None:
    os.replace(tmp, final)
    _fsync_dir(directory)


def atomic_write_json(path: str, obj: Any) -> None:
    """Durably publish ``obj`` as JSON at ``path``: same-directory temp
    file, fsync, ``os.replace`` into place, fsync the directory. The kernel
    autotune table publishes through this."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp.{os.path.basename(path)}")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    _publish(tmp, path, directory)


def save_checkpoint(path: str, tree: Any, step: int, extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` to the directory ``path`` as step ``step``.

    The payload is made durable (fsync, atomic rename, directory fsync)
    BEFORE its manifest is written and published the same way: the
    manifest's publish is the commit point. ``extra`` merges caller
    metadata into the manifest (the reserved keys win); the sweep
    checkpoint store records its summary-metric names there.
    """
    os.makedirs(path, exist_ok=True)
    names, leaves = _flatten_with_names(tree)
    arrays = [_to_numpy(l) for l in leaves]
    payload = {f"arr_{i}": a for i, a in enumerate(arrays)}
    tmp_npz = os.path.join(path, f".tmp.{step}.npz")
    final_npz = os.path.join(path, f"step_{step:08d}.npz")
    with open(tmp_npz, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    with open(tmp_npz, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    _publish(tmp_npz, final_npz, path)
    manifest = dict(extra or {})
    manifest.update(
        step=step,
        names=names,
        dtypes=[str(a.dtype) for a in arrays],
        shapes=[list(a.shape) for a in arrays],
        sha256=digest,
    )
    tmp_man = os.path.join(path, f".tmp.{step}.json")
    with open(tmp_man, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _publish(tmp_man, os.path.join(path, f"step_{step:08d}.json"), path)
    return final_npz


def read_manifest(path: str, step: int) -> Optional[dict]:
    """The step's manifest dict, or None if absent or unparseable."""
    try:
        with open(os.path.join(path, f"step_{step:08d}.json")) as f:
            man = json.load(f)
        return man if isinstance(man, dict) else None
    except (OSError, ValueError):
        return None


def verify_checkpoint(path: str, step: int) -> bool:
    """Whether the (manifest, payload) pair commits this step.

    Any torn state (a missing file, an unparseable or wrong-step manifest,
    a checksum mismatch) means the step was never durably written and is
    treated exactly like an absent one.
    """
    man = read_manifest(path, step)
    npz_p = os.path.join(path, f"step_{step:08d}.npz")
    if man is None or not os.path.exists(npz_p):
        return False
    if man.get("step") != step or not isinstance(man.get("sha256"), str):
        return False
    try:
        with open(npz_p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest() == man["sha256"]
    except OSError:
        return False


def _torch_dtype(leaf: Any) -> Optional[torch.dtype]:
    """The dtype a restored leaf takes from its ``like`` leaf, if any."""
    if isinstance(getattr(leaf, "dtype", None), torch.dtype):  # tensors, sharded ones
        return leaf.dtype
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.empty(0, leaf.dtype)).dtype
    return None


def load_checkpoint(path: str, step: int, like: Any, device: DeviceLike = None) -> Any:
    """Step ``step`` in the structure of ``like``, every leaf a tensor on
    ``device`` (None: the CUDA card) with the dtype of its ``like`` leaf
    where that leaf has one."""
    dev = resolve_device(device)
    with np.load(os.path.join(path, f"step_{step:08d}.npz")) as data:
        arrays = [data[f"arr_{i}"] for i in range(len(data.files))]
    _, leaves = _flatten_with_names(like)
    out = []
    for arr, leaf in zip(arrays, leaves):
        t = torch.from_numpy(arr)
        out.append(t.to(device=dev, dtype=_torch_dtype(leaf) or t.dtype))
    return _unflatten(like, iter(out))


def load_checkpoint_arrays(path: str, step: int) -> list[np.ndarray]:
    """The step's payload as host arrays in manifest order, no ``like``
    tree needed: the restore of flat stores (the sweep's chunk summaries)
    whose structure lives in the manifest."""
    with np.load(os.path.join(path, f"step_{step:08d}.npz")) as data:
        return [data[f"arr_{i}"] for i in range(len(data.files))]


def available_steps(path: str) -> list[int]:
    """Steps with a payload file in ``path``, ascending (valid or not)."""
    if not os.path.isdir(path):
        return []
    steps = []
    for f in os.listdir(path):
        if f.startswith("step_") and f.endswith(".npz"):
            try:
                steps.append(int(f[5:13]))
            except ValueError:
                continue
    return sorted(steps)
