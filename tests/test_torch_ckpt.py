"""The port's checkpoint layer (``repro_torch.ckpt``) case by case against
``tests/test_ckpt.py``, on the CPU, and across packages: a step either
package writes is verified and loaded by the other.

The crash model: ``save_checkpoint`` publishes the payload durably FIRST
and the manifest strictly after, so every interruption (simulated by
truncating files, deleting one half of the pair, or aborting between the
two ``os.replace`` calls) leaves a state ``verify_checkpoint`` reads as
"not written", and ``latest_valid_step`` falls back to the newest
checkpoint that restores. Tolerances: none; restored arrays are bit for
bit what was saved.
"""
import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.ckpt import CheckpointManager as JManager
from repro.ckpt import checkpoint as JC
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import checkpoint as C

CPU = "cpu"


def _tree(v: float):
    return {"w": torch.full((3, 2), v), "opt": {"m": torch.arange(4.0)}}


def _paths(d, step):
    return (os.path.join(d, f"step_{step:08d}.npz"), os.path.join(d, f"step_{step:08d}.json"))


def _leaves(tree):
    return C._flatten_with_names(tree)[1]


# ----------------------------------------------------------- round trip ---
def test_roundtrip_preserves_tree_and_dtypes(tmp_path):
    d = str(tmp_path)
    tree = {
        "f32": torch.ones((2, 3), dtype=torch.float32),
        "i32": torch.arange(5, dtype=torch.int32),
        "nested": {"b": torch.zeros(1, dtype=torch.bool)},
    }
    C.save_checkpoint(d, tree, 3)
    assert C.verify_checkpoint(d, 3)
    out = C.load_checkpoint(d, 3, tree, device=CPU)
    assert list(out) == sorted(tree)
    for got, want in zip(_leaves(out), _leaves(tree)):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_restore_places_leaves_on_the_device(tmp_path):
    """The counterpart of the reference's sharding-aware restore: every
    leaf lands on ``device``; lists, tuples and namedtuples keep their
    types."""
    d = str(tmp_path)
    Pair = collections.namedtuple("Pair", "x y")
    tree = {"p": Pair(torch.ones(2), [torch.zeros(3, dtype=torch.int64), 2.5]),
            "t": (torch.arange(3.0),), "none": None}
    C.save_checkpoint(d, tree, 1)
    out = C.load_checkpoint(d, 1, tree, device=torch.device(CPU))
    assert isinstance(out["p"], Pair) and isinstance(out["p"].y, list)
    assert isinstance(out["t"], tuple) and out["none"] is None
    for got, want in zip(_leaves(out), _leaves(tree)):
        assert isinstance(got, torch.Tensor) and got.device.type == CPU
        assert torch.equal(got, torch.as_tensor(want, dtype=got.dtype))


def test_load_checkpoint_arrays_flat_restore(tmp_path):
    """The like-free restore returns host arrays in manifest order, and
    ``extra`` survives in the manifest: the sweep-resume path."""
    d = str(tmp_path)
    arrays = [np.arange(6.0).reshape(2, 3), np.ones(4, np.int64)]
    C.save_checkpoint(d, arrays, 0, extra={"metrics": ["a", "b"]})
    man = C.read_manifest(d, 0)
    assert man["metrics"] == ["a", "b"]
    assert man["step"] == 0  # reserved keys win over extra
    out = C.load_checkpoint_arrays(d, 0)
    assert len(out) == 2
    for got, want in zip(out, arrays):
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------- across the packages ---
def _jtree(v: float):
    return {"w": jnp.full((3, 2), v), "opt": {"m": jnp.arange(4.0)},
            "seq": [jnp.arange(3, dtype=jnp.int32), (jnp.zeros(2, jnp.bool_),)]}


def _ttree(v: float):
    return {"w": torch.full((3, 2), v), "opt": {"m": torch.arange(4.0)},
            "seq": [torch.arange(3, dtype=torch.int32), (torch.zeros(2, dtype=torch.bool),)]}


def test_port_names_and_manifest_match_the_reference(tmp_path):
    """Both packages write the same leaf names, dtypes and shapes for the
    same tree, and the same manifest keys."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    JC.save_checkpoint(jd, _jtree(1.5), 7, extra={"metrics": ["m"]})
    C.save_checkpoint(td, _ttree(1.5), 7, extra={"metrics": ["m"]})
    jm, tm = JC.read_manifest(jd, 7), C.read_manifest(td, 7)
    assert set(tm) == set(jm)
    for key in ("step", "names", "dtypes", "shapes", "metrics"):
        assert tm[key] == jm[key], key
    assert tm["names"] == [jax.tree_util.keystr(p) for p, _ in
                           jax.tree_util.tree_flatten_with_path(_jtree(0.0))[0]]


def test_reference_step_verifies_and_loads_in_the_port(tmp_path):
    d = str(tmp_path)
    JC.save_checkpoint(d, _jtree(2.0), 4)
    assert C.verify_checkpoint(d, 4)
    assert C.available_steps(d) == [4]
    out = C.load_checkpoint(d, 4, _ttree(0.0), device=CPU)
    for got, want in zip(_leaves(out), _leaves(_ttree(2.0))):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert CheckpointManager(d, keep=None).latest_valid_step() == 4


def test_port_step_verifies_and_loads_in_the_reference(tmp_path):
    d = str(tmp_path)
    C.save_checkpoint(d, _ttree(3.0), 5)
    assert JC.verify_checkpoint(d, 5)
    out = JC.load_checkpoint(d, 5, _jtree(0.0))
    for got, want in zip(jax.tree.leaves(out), jax.tree.leaves(_jtree(3.0))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert JManager(d, keep=None).latest_valid_step() == 5


# ----------------------------------------------------------- torn writes ---
def test_torn_payload_detected(tmp_path):
    d = str(tmp_path)
    C.save_checkpoint(d, _tree(1.0), 5)
    npz, _ = _paths(d, 5)
    with open(npz, "r+b") as f:  # truncate mid-payload
        f.truncate(os.path.getsize(npz) // 2)
    assert not C.verify_checkpoint(d, 5)


def test_crash_between_payload_and_manifest_publish(tmp_path, monkeypatch):
    """Abort save between the two os.replace calls: a NEW payload beside
    the OLD same-step manifest must not count as written, and restore
    falls back."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=3, every=1)
    mgr.save(1, _tree(1.0))
    mgr.save(2, _tree(2.0))
    real_replace = os.replace

    def crashing_replace(src, dst):
        real_replace(src, dst)
        if dst.endswith(".npz"):  # payload published; die before manifest
            raise KeyboardInterrupt("simulated SIGKILL")

    monkeypatch.setattr(os, "replace", crashing_replace)
    with pytest.raises(KeyboardInterrupt):
        C.save_checkpoint(d, _tree(99.0), 2)  # overwrite step 2
    monkeypatch.setattr(os, "replace", real_replace)

    assert not C.verify_checkpoint(d, 2)
    mgr2 = CheckpointManager(d, keep=3, every=1)
    assert mgr2.latest_valid_step() == 1
    _, out = mgr2.restore(_tree(0.0), device=CPU)
    assert torch.equal(out["w"], torch.full((3, 2), 1.0))


def test_crash_before_payload_publish_keeps_old_pair(tmp_path, monkeypatch):
    """Abort before the payload replace: the previous checkpoint at the
    same step stays valid, and the .tmp orphan is swept by the next
    manager."""
    d = str(tmp_path)
    C.save_checkpoint(d, _tree(7.0), 4)

    def crashing_replace(src, dst):
        raise KeyboardInterrupt("simulated SIGKILL before publish")

    monkeypatch.setattr(os, "replace", crashing_replace)
    with pytest.raises(KeyboardInterrupt):
        C.save_checkpoint(d, _tree(8.0), 4)
    monkeypatch.undo()

    assert C.verify_checkpoint(d, 4)
    out = C.load_checkpoint(d, 4, _tree(0.0), device=CPU)
    assert torch.equal(out["w"], torch.full((3, 2), 7.0))
    assert any(f.startswith(".tmp.") for f in os.listdir(d))
    CheckpointManager(d, keep=3, every=1)  # init sweeps orphans
    assert not any(f.startswith(".tmp.") for f in os.listdir(d))
    assert C.verify_checkpoint(d, 4)


def test_manifest_without_payload_and_garbage_manifest(tmp_path):
    d = str(tmp_path)
    C.save_checkpoint(d, _tree(1.0), 9)
    npz, man = _paths(d, 9)
    os.remove(npz)
    assert not C.verify_checkpoint(d, 9)
    C.save_checkpoint(d, _tree(1.0), 9)
    with open(man, "w") as f:
        f.write("{not json")
    assert not C.verify_checkpoint(d, 9)
    C.save_checkpoint(d, _tree(1.0), 9)
    with open(man) as f:
        m = json.load(f)
    m["step"] = 8  # a wrong-step manifest is stale by definition
    with open(man, "w") as f:
        json.dump(m, f)
    assert not C.verify_checkpoint(d, 9)


# -------------------------------------------------------------- rotation ---
def test_rotate_keeps_newest_valid_not_newest_torn(tmp_path):
    """Torn newest writes must not evict the older valid one: rotation
    counts valid checkpoints only."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, every=1)
    mgr.save(10, _tree(10.0))
    for s in (11, 12, 13, 14):
        mgr.save(s, _tree(float(s)))
        os.remove(_paths(d, s)[1])
    assert mgr.latest_valid_step() == 10
    _, out = mgr.restore(_tree(0.0), device=CPU)
    assert torch.equal(out["w"], torch.full((3, 2), 10.0))


def test_rotate_reclaims_torn_steps_below_newest_valid(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, every=1)
    mgr.save(1, _tree(1.0))
    os.remove(_paths(d, 1)[1])  # torn old step
    mgr.save(2, _tree(2.0))
    mgr.save(3, _tree(3.0))
    assert not os.path.exists(_paths(d, 1)[0])
    assert C.available_steps(d) == [2, 3]


def test_rotate_valid_only_basic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    assert C.available_steps(str(tmp_path)) == [3, 4]
    assert mgr.latest_valid_step() == 4


def test_keep_none_retains_everything(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=None, every=1)
    for s in range(6):
        mgr.save(s, _tree(float(s)))
    assert C.available_steps(str(tmp_path)) == list(range(6))


def test_restore_of_an_empty_directory(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore(_tree(0.0), device=CPU) == (None, None)


# --------------------------------------------------------------- cadence ---
def test_maybe_save_cadence(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=None, every=3)
    saved = [s for s in range(1, 10) if mgr.maybe_save(s, _tree(float(s)))]
    assert saved == [3, 6, 9]
    assert C.available_steps(str(tmp_path)) == [3, 6, 9]


def test_restore_without_device_needs_the_card(tmp_path):
    """Entry points run on the card unless told otherwise: without a card,
    a restore that names no device raises instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    C.save_checkpoint(str(tmp_path), _tree(1.0), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.load_checkpoint(str(tmp_path), 0, _tree(0.0))


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    """numpy has no bf16: a bf16 leaf is stored as float32 (every bf16
    value exactly) and cast back to its ``like`` leaf's dtype on restore,
    so a bf16 model's training state restarts bit for bit."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32), "b": [torch.randn(4, generator=g)]}
    C.save_checkpoint(str(tmp_path), tree, 1)
    assert C.read_manifest(str(tmp_path), 1)["dtypes"] == ["float32", "int32", "float32"]
    out = C.load_checkpoint(str(tmp_path), 1, tree, CPU)
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], tree["w"])
    assert torch.equal(out["step"], tree["step"]) and torch.equal(out["b"][0], tree["b"][0])
