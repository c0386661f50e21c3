"""The port's sharding policy, mesh context and meshes against the JAX
package's (``repro.train.sharding``, ``repro.train.meshctx``,
``repro.launch.mesh``).

The policy is pure shape logic, so both packages run on the same fake mesh
object (``tests/test_sharding.py``'s): every leaf of all ten configs'
parameters, decode caches and input batches gets the same PartitionSpec,
exactly, on the meshes (16, 16), (2, 16, 16), (2, 4), (8, 1) and (1, 1). A
block leaf's spec is the reference's with its leading None dropped (the
port keeps one dict a layer, without the reference's stacked layer dim).
``NamedSharding.shard_shape`` and ``indices`` are held to JAX's
``shard_shape`` and ``devices_indices_map`` on 8 host devices (one
subprocess).
"""
import functools
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_oracle import leaves, record_hints, run_oracle
from repro.configs import base as jconfigs
from repro.configs import shapes as jshapes
from repro.models import model as JM
from repro.train import meshctx as jmc
from repro.train import sharding as jshd
from repro.train import train_step as jts
from repro_torch.configs import base as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.train import meshctx as tmc
from repro_torch.train import sharding as shd
from repro_torch.train import train_step as tts
from repro_torch.train.sharding import P


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": SINGLE, "2x16x16": MULTI, "2x4": FakeMesh({"data": 2, "model": 4}),
          "8x1": FakeMesh({"data": 8, "model": 1}), "1x1": FakeMesh({"data": 1, "model": 1})}
ARCHS = jconfigs.names()


def _entries(spec) -> tuple:
    """A PartitionSpec of either package as a plain tuple of entries."""
    return tuple(list(spec))


def _ref_leaves(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): spec
            for path, spec in flat}


def _expand_blocks(ref: dict, n_layers: int) -> dict:
    """The reference's leaves keyed as the port's: a block leaf once a
    layer, its leading (layer) entry dropped."""
    out = {}
    for path, spec in ref.items():
        entries = _entries(spec)
        if path[0] == "blocks":
            assert entries[0] is None, (path, spec)  # the scan dim is never sharded
            for i in range(n_layers):
                out[("blocks", i) + path[1:]] = entries[1:]
        else:
            out[path] = entries
    return out


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    return JM.param_shapes(jconfigs.get(arch)), TM.param_shapes(tconfigs.get(arch))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh):
    ref_shapes, port_shapes = _param_shapes(arch)
    m = MESHES[mesh]
    want = _expand_blocks(_ref_leaves(jshd.param_pspecs(ref_shapes, m)),
                          jconfigs.get(arch).n_layers)
    specs = leaves(shd.param_pspecs(port_shapes, m))
    assert set(specs) == set(want) and all(isinstance(s, P) for s in specs.values())
    for path in want:
        assert _entries(specs[path]) == want[path], (arch, mesh, path)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_match_reference(arch, mesh):
    """Decode caches (stacked in both packages, the same rule) at
    decode_32k and, for the sub-quadratic families, long_500k; the input
    batches of train_4k and prefill_32k and decode's token ids, with
    ``pure_dp`` on and off."""
    m = MESHES[mesh]
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for name in jshapes.SHAPES:
        if not jshapes.applicable(jcfg, jshapes.SHAPES[name])[0]:
            continue
        ref = jts.input_specs(jcfg, jshapes.SHAPES[name])
        port = tts.input_specs(tcfg, tshapes.SHAPES[name])
        if "cache" in ref:
            want = {k: _entries(v)
                    for k, v in _ref_leaves(jshd.cache_pspecs(ref["cache"], m)).items()}
            got = {k: _entries(v)
                   for k, v in leaves(shd.cache_pspecs(port["cache"], m)).items()}
            assert got == want, (arch, mesh, name)
            ref_b, port_b = {"tokens": ref["tokens"]}, {"tokens": port["tokens"]}
        else:
            ref_b, port_b = ref["batch"], port["batch"]
        for pure_dp in (False, True):
            want = {k: _entries(v) for k, v in
                    _ref_leaves(jshd.batch_pspecs(ref_b, m, pure_dp=pure_dp)).items()}
            got = {k: _entries(v) for k, v in
                   leaves(shd.batch_pspecs(port_b, m, pure_dp=pure_dp)).items()}
            assert got == want, (arch, mesh, name, pure_dp)


AUTO_CASES = [
    ((163840, 7168), {}), ((3584, 28, 128), {}), ((256, 4096), dict(batch_dim=0, skip_dims=(1,))),
    ((1, 524288), dict(batch_dim=0, skip_dims=(1,))), ((64, 8, 16), dict(skip_dims=(0,))),
    ((6, 10, 3), {}), ((32, 32), {}), ((16,), {}), ((2, 48, 7), dict(batch_dim=1)),
    ((128, 32768, 8, 128), dict(skip_dims=(0,), batch_dim=1)), ((), {}),
]


@pytest.mark.parametrize("mesh", MESHES)
def test_auto_pspec_matches_reference(mesh):
    m = MESHES[mesh]
    for shape, kw in AUTO_CASES:
        got, want = shd.auto_pspec(shape, m, **kw), jshd.auto_pspec(shape, m, **kw)
        assert _entries(got) == _entries(want), (shape, kw)
    assert shd.dp_axes(m) == jshd.dp_axes(m)


# ---- twins of tests/test_sharding.py ----------------------------------------
def test_auto_pspec_tp_then_fsdp():
    assert shd.auto_pspec((163840, 7168), SINGLE) == P("model", ("data",))


def test_auto_pspec_skips_nondivisible_heads():
    p = shd.auto_pspec((3584, 28, 128), SINGLE)
    assert p[0] == "model" and p[1] is None


def test_auto_pspec_multi_pod_batch():
    assert shd.auto_pspec((256, 4096), MULTI, batch_dim=0, skip_dims=(1,))[0] == ("pod", "data")


def test_auto_pspec_batch_fallback_when_indivisible():
    assert shd.auto_pspec((1, 524288), MULTI, batch_dim=0, skip_dims=(1,))[0] is None


def test_param_pspecs_blocks_have_no_layer_dim():
    specs = shd.param_pspecs(TM.param_shapes(tconfigs.get("qwen2-72b")), SINGLE)
    wq = specs["blocks"][0]["attn"]["wq"]  # (8192, 8192): the reference's (80, 8192, 8192)
    assert len(wq) == 2 and wq == P("model", "data")


def test_param_pspecs_moe_experts_on_model():
    specs = shd.param_pspecs(TM.param_shapes(tconfigs.get("kimi-k2-1t-a32b")), SINGLE)
    assert specs["blocks"][0]["moe"]["gate"] == P("model", ("data",), None)  # (384, 7168, 2048)


def test_every_arch_fully_specced():
    for name in tconfigs.names():
        shapes = leaves(TM.param_shapes(tconfigs.get(name)))
        specs = leaves(shd.param_pspecs(TM.param_shapes(tconfigs.get(name)), MULTI))
        for path, leaf in shapes.items():
            spec = specs[path]
            assert isinstance(spec, P) and len(spec) == leaf.dim()
            for dim, axes in enumerate(spec):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else axes
                assert leaf.shape[dim] % int(np.prod([MULTI.shape[a] for a in axes])) == 0


def test_partition_spec_normalises_as_jax():
    assert P(("data",), ()) == ("data", None) == _entries(JP(("data",), ()))
    entries = ("model", ("pod", "data"), None)
    assert _entries(P(*entries)) == _entries(JP(*entries))


# ---- meshctx ---------------------------------------------------------------------
CONSTRAIN_CASES = [
    ((4, 16, 8), ("data", "model", None)), ((4, 16, 8), ("batch", None, None)),
    ((4, 16, 4, 16), ("data", None, "model", None)), ((3, 16, 8), ("data", "model", None)),
    ((8, 6, 64), ("model", "data", None)), ((2, 1, 8), ("data", "model")),
    ((16, 16), ("data", "model", None)[:2]), ((4, 16, 8), (None, None, None)), ((4, 4), ()),
]


@pytest.mark.parametrize("mesh", MESHES)
def test_constrain_resolves_as_the_reference(mesh, monkeypatch):
    """The spec the port resolves is the one the reference's ``constrain``
    hands to ``with_sharding_constraint`` (captured here), and the port
    returns its input itself."""
    m = MESHES[mesh]
    monkeypatch.setattr(jmc, "NamedSharding", lambda mesh_, spec: spec)
    monkeypatch.setattr(jmc, "jax", SimpleNamespace(
        lax=SimpleNamespace(with_sharding_constraint=lambda x, spec: spec)))
    log = record_hints(monkeypatch)
    for shape, spec in CONSTRAIN_CASES:
        with jmc.use_mesh(m):
            want = jmc.constrain(SimpleNamespace(shape=shape), *spec)
        x = torch.zeros(shape)
        with tmc.use_mesh(m):
            assert tmc.constrain(x, *spec) is x
        assert len(log) == 1 and log[0][0] == shape
        assert _entries(log.pop()[1]) == _entries(want), (shape, spec)


def test_constrain_without_a_mesh_is_identity_and_unrecorded(monkeypatch):
    log = record_hints(monkeypatch)
    x = torch.ones(4, 8)
    assert tmc.constrain(x, "data", "model") is x
    assert log == [] and tmc.current_mesh() is None


def test_constrain_validates_the_hint():
    m = MESHES["2x4"]
    with tmc.use_mesh(m):
        with pytest.raises(ValueError):
            tmc.constrain(torch.zeros(4, 8), "data", "model", None)  # 3 entries, 2 dims
        with pytest.raises(ValueError):
            tmc.constrain(torch.zeros(4, 8), "stage", None)
        with tmc.use_mesh(MESHES["8x1"]):  # nested meshes: the inner one is current
            assert tmc.current_mesh() is MESHES["8x1"]
        assert tmc.current_mesh() is m
    assert tmc.current_mesh() is None


def test_mesh_positions_and_devices():
    m = tmc.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.axis_names == ("data", "model")
    assert m.devices.shape == (2, 4)
    assert list(m.coords())[:3] == [(0, 0), (0, 1), (0, 2)]
    assert m.device(data=1, model=3) == torch.device("cpu")
    assert tmc.dp_positions(m) == [{"data": 0}, {"data": 1}]
    pod = tmc.make_mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    assert tmc.dp_positions(pod) == [{"pod": 0, "data": 0}, {"pod": 0, "data": 1},
                                     {"pod": 1, "data": 0}, {"pod": 1, "data": 1}]
    with pytest.raises(ValueError):
        m.device(stage=0)


def test_mesh_refuses_fewer_devices_than_positions():
    with pytest.raises(ValueError):
        tmc.make_mesh((2, 4), ("data", "model"), ["cpu"] * 7)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):  # no CUDA device: never the CPU instead
            tmc.make_mesh((1,), ("data",))
        with pytest.raises(ValueError):
            tmesh.make_production_mesh()


def test_production_and_host_meshes():
    single = tmesh.make_production_mesh(devices=["cpu"] * 256)
    multi = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert shd.dp_axes(multi) == jshd.dp_axes(FakeMesh(multi.shape)) == ("pod", "data")
    host = tmesh.make_host_mesh(4)
    assert host.shape == {"data": 4} and all(d == torch.device("cpu") for d in host.devices.flat)
    assert tmesh.make_host_mesh(2, axis="model").shape == {"model": 2}
    assert tmesh.make_host_mesh().shape == {"data": 1}


# ---- NamedSharding against JAX's, 8 host devices ------------------------------------
SHARDING_CASES = [
    ((8,), ("data",), ("data", None), (16, 3)),
    ((2, 4), ("data", "model"), ("model", ("data",), None), (8, 6, 5)),
    ((2, 4), ("data", "model"), (("data", "model"), None), (16, 3)),
    ((2, 4), ("data", "model"), (("model", "data"),), (16, 3)),
    ((8, 1), ("data", "model"), ("model", "data", None), (4, 16, 3)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"), (4, 6)),
    ((2, 4), ("data", "model"), (None, None), (5, 7)),
    ((2, 4), ("data", "model"), (), (3,)),
    ((1, 8), ("data", "model"), ("model",), (384, 64, 32)),
]

_SHARDING_SCRIPT = """
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

cases = json.loads(sys.argv[2])
out = []
for mesh_shape, axes, spec, shape in cases:
    mesh = jax.make_mesh(tuple(mesh_shape), tuple(axes))
    ns = NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e for e in spec]))
    dim = ns.devices_indices_map(tuple(shape))
    idx = {}
    for coord in np.ndindex(mesh.devices.shape):
        idx[",".join(map(str, coord))] = [[s.start, s.stop] for s in dim[mesh.devices[coord]]]
    out.append({"shard_shape": list(ns.shard_shape(tuple(shape))), "indices": idx})
try:
    NamedSharding(jax.make_mesh((2, 4), ("data", "model")), P("model")).shard_shape((6,))
    out.append("divided")
except ValueError:
    out.append("ValueError")
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_shardings(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding") / "oracle.json"
    script = _SHARDING_SCRIPT.replace("sys.argv[2]", repr(json.dumps(SHARDING_CASES)))
    run_oracle(script, 8, path)
    return json.loads(path.read_text())


@pytest.mark.parametrize("case", range(len(SHARDING_CASES)))
def test_named_sharding_matches_jax(jax_shardings, case):
    mesh_shape, axes, spec, shape = SHARDING_CASES[case]
    mesh = tmc.make_mesh(mesh_shape, axes, ["cpu"] * int(np.prod(mesh_shape)))
    ns = shd.NamedSharding(mesh, P(*spec))
    want = jax_shardings[case]
    assert list(ns.shard_shape(shape)) == want["shard_shape"]
    got = {",".join(map(str, c)): [[s.start, s.stop] for s in idx]
           for c, idx in ns.indices(shape).items()}
    assert got == want["indices"]


def test_named_sharding_refuses_indivisible_dims_as_jax(jax_shardings):
    assert jax_shardings[-1] == "ValueError"
    with pytest.raises(ValueError):
        shd.NamedSharding(tmc.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8),
                          P("model")).shard_shape((6,))


def test_shardings_maps_every_spec():
    mesh = tmc.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    shapes = TM.param_shapes(tconfigs.reduced(tconfigs.get("stablelm-3b")))
    sh = leaves(shd.shardings(shd.param_pspecs(shapes, mesh), mesh))
    for path, leaf in leaves(shapes).items():
        assert isinstance(sh[path], shd.NamedSharding) and sh[path].mesh is mesh
        assert len(sh[path].shard_shape(tuple(leaf.shape))) == leaf.dim()
