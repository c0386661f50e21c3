"""Elastic rescale on the CPU against the JAX package's
(``tests/test_elastic.py``'s twin): a tree placed on a (data 8, model 1)
mesh, checkpointed, and loaded onto (data 2, model 4), in both directions
between the packages, bit for bit.

One subprocess with 8 host devices runs the reference: its ``reshard`` and
``save_checkpoint`` on (8, 1), and its ``rescale_checkpoint`` onto (2, 4)
of the step the port wrote (before the subprocess starts). The port loads
the reference's step with its own ``rescale_checkpoint`` onto (2, 4) on
``["cpu"] * 8``. Values are equal bit for bit; each shard has the shape
the reference places (``shard_shape``), under the same spec.
"""
import json

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_oracle import leaves, run_oracle
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import base as tconfigs
from repro_torch.launch import elastic
from repro_torch.models import model as TM
from repro_torch.train import meshctx as tmc
from repro_torch.train import sharding as shd

STEP = 7


def _tree() -> dict:
    """The reference test's tree, and leaves of other ranks and dtypes."""
    rng = np.random.default_rng(0)
    return {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8), "b": np.ones(8, np.float32),
            "e": rng.standard_normal((4, 8, 6)).astype(np.float32),
            "n": rng.integers(-5, 5, (16, 3)).astype(np.int32), "s": np.float32(3.5)}


def _port(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


_SCRIPT = """
import json, sys
import jax, numpy as np
from repro.ckpt import checkpoint as C
from repro.launch.elastic import rescale_checkpoint, reshard

out_path, port_dir, jax_dir = sys.argv[1], sys.argv[2], sys.argv[3]
data = np.load(port_dir + "/tree.npz")
tree = {k: jax.numpy.asarray(data[k]) for k in data.files}
mesh_a = jax.make_mesh((8, 1), ("data", "model"))
mesh_b = jax.make_mesh((2, 4), ("data", "model"))
C.save_checkpoint(jax_dir, reshard(tree, mesh_a), %d)
res = {}
for tag, d in (("from_port", port_dir), ("own", jax_dir)):
    got = rescale_checkpoint(d, %d, tree, mesh_b)
    for k, v in got.items():
        res[f"{tag}/{k}"] = np.asarray(v)
        res[f"{tag}/{k}/shard_shape"] = np.asarray(v.sharding.shard_shape(v.shape), np.int64)
        res[f"{tag}/{k}/spec"] = np.asarray(json.dumps([list(e) if isinstance(e, tuple) else e
                                                        for e in v.sharding.spec]))
np.savez(out_path, **res)
""" % (STEP, STEP)


MESH_A, MESH_B = ((8, 1), ("data", "model")), ((2, 4), ("data", "model"))


def _mesh(shape, axes):
    return tmc.make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The port's step (written on (8, 1) before the reference runs), the
    reference's step, and the reference's reading of both on (2, 4)."""
    root = tmp_path_factory.mktemp("elastic")
    port_dir, jax_dir = root / "port", root / "jax"
    port_dir.mkdir()
    tree = _tree()
    np.savez(port_dir / "tree.npz", **tree)
    C.save_checkpoint(str(port_dir), elastic.reshard(_port(tree), _mesh(*MESH_A)), STEP)
    out = root / "oracle.npz"
    run_oracle(_SCRIPT, 8, out, port_dir, jax_dir)
    with np.load(out) as data:
        ref = {k: data[k] for k in data.files}
    return {"tree": tree, "jax_dir": str(jax_dir), "ref": ref}


def _shapes_and_devices(placed: dict, ref: dict, tag: str):
    for k, leaf in placed.items():
        assert isinstance(leaf, shd.ShardedTensor)
        want = tuple(int(n) for n in ref[f"{tag}/{k}/shard_shape"])
        assert leaf.sharding.shard_shape(leaf.shape) == want, k
        assert [list(e) if isinstance(e, tuple) else e for e in leaf.sharding.spec] == \
            json.loads(str(ref[f"{tag}/{k}/spec"])), k
        assert len(leaf.shards) == 8
        for t in leaf.shards.values():
            assert tuple(t.shape) == want and t.device == torch.device("cpu")


def test_port_loads_the_reference_step_onto_a_new_mesh(oracle):
    like = _port(oracle["tree"])
    out = elastic.rescale_checkpoint(oracle["jax_dir"], STEP, like, _mesh(*MESH_B))
    _shapes_and_devices(out, oracle["ref"], "own")
    for k, v in elastic.gather(out).items():
        assert v.dtype == like[k].dtype and torch.equal(v, like[k]), k


def test_reference_loads_the_port_step_onto_a_new_mesh(oracle):
    for k, v in oracle["tree"].items():
        got = oracle["ref"][f"from_port/{k}"]
        assert got.dtype == v.dtype and np.array_equal(got, v), k
        # the reference's own round trip reads the same values
        assert np.array_equal(oracle["ref"][f"own/{k}"], v), k


def test_port_round_trip_on_the_new_mesh(oracle, tmp_path):
    """The port's own step, written on (8, 1), rescaled onto (2, 4): the
    placement of the reference's ``rescale_checkpoint``."""
    tree = _port(oracle["tree"])
    C.save_checkpoint(str(tmp_path), elastic.reshard(tree, _mesh(*MESH_A)), STEP)
    out = elastic.rescale_checkpoint(str(tmp_path), STEP, tree, _mesh(*MESH_B))
    _shapes_and_devices(out, oracle["ref"], "own")
    assert all(torch.equal(elastic.gather(out)[k], tree[k]) for k in tree)


DM = ("data", "model")
MESHES = [((8, 1), DM), ((2, 4), DM), ((1, 8), DM), ((2, 2, 2), ("pod",) + DM), ((4, 2), DM),
          ((1, 1), DM)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_gather_of_reshard_is_the_tree(mesh):
    """Every leaf back bit for bit: the test tree, and a reduced config's
    parameters (bf16 included) under the parameter policy; every shard
    its own copy, of the shape the sharding gives."""
    m = _mesh(*mesh)
    params = TM.init_params(tconfigs.reduced(tconfigs.get("stablelm-3b")), 0, "cpu")
    params["blocks"][0]["ln1"] = params["blocks"][0]["ln1"].to(torch.bfloat16)
    for tree in (_port(_tree()), params):
        placed = elastic.reshard(tree, m)
        back = elastic.gather(placed)
        flat_t, flat_p, flat_b = (leaves(t) for t in (tree, placed, back))
        for path, t in flat_t.items():
            s = flat_p[path]
            assert s.sharding.mesh is m and s.dtype == t.dtype
            assert flat_b[path].dtype == t.dtype and torch.equal(flat_b[path], t), path
            for local in s.shards.values():
                assert tuple(local.shape) == s.sharding.shard_shape(tuple(t.shape))
                assert local.numel() == 0 or local.data_ptr() != t.data_ptr()
        # resharding a placed tree onto another mesh keeps every value
        again = elastic.gather(elastic.reshard(placed, _mesh((2, 4), ("data", "model"))))
        assert all(torch.equal(a, flat_t[k]) for k, a in leaves(again).items())


def test_a_placed_tree_writes_the_checkpoint_of_the_whole_tree(tmp_path):
    """``save_checkpoint`` of a placed tree writes the gathered leaves
    (the reference's ``device_get``): the same payload as the whole tree."""
    tree = _port(_tree())
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    C.save_checkpoint(a, tree, 1)
    C.save_checkpoint(b, elastic.reshard(tree, _mesh(*MESH_B)), 1)
    xs, ys = C.load_checkpoint_arrays(a, 1), C.load_checkpoint_arrays(b, 1)
    assert len(xs) == len(ys)
    assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(xs, ys))
    assert C.read_manifest(a, 1)["names"] == C.read_manifest(b, 1)["names"]
