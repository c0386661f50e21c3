"""The port's expert- and tensor-parallel layers on a (data 2, model 4)
mesh of ``["cpu"] * 8`` against the JAX package's shard_map layers on 8
host devices (``tests/test_moe_ep.py``'s twin, with its gradient taken
under ``jax.jit``).

One subprocess computes every reference case at once: ``apply_moe_ep`` on
test_moe_ep's full sequence (4, 16, 32) and decode (8, 1, 32) batches at
capacity factor 8.0 (nothing drops) and 1.25 (capacity binds), its
gradients with respect to the parameters and the tokens, ``apply_mlp_ep``
and its ``swiglu_apply`` fallback (d_ff % tp != 0), and ``block_forward``
of the reduced MoE configs' first layer under the mesh.

Bars: outputs within 1e-5 of their largest magnitude (JAX's own EP reads
4.8e-7 from per-shard ``apply_moe``), gradients within 1e-5 of each leaf's
largest magnitude (JAX: 2.0e-7); the kept (token, expert) pairs exact.
Capacity is counted per data shard: at cf 1.25 the layer is ``apply_moe``
over each data shard's tokens, not over the whole batch.
"""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_oracle import leaves, nested, run_oracle
from repro_torch.configs import base as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import swiglu_apply
from repro_torch.train import meshctx as tmc

RTOL_OF_MAX = 1e-5
SHAPES = {"full": (4, 16, 32), "decode": (8, 1, 32)}
FACTORS = (8.0, 1.25)
LAYER_ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")
LAYER_TOKENS = (4, 16)

_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import base as configs
from repro.configs.base import ArchConfig
from repro.models import model as M, moe as moe_lib, transformer as tf
from repro.models.layers import swiglu_apply, swiglu_init
from repro.train.meshctx import use_mesh

SHAPES, FACTORS = %r, %r
LAYER_ARCHS, (B, S) = %r, %r
# Auto axes (jax.sharding.Mesh's default): the reference's constrain hands
# with_sharding_constraint specs that jax 0.9.0 refuses on the Explicit axes
# jax.make_mesh makes
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
res = {}


def save(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        res[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


p = moe_lib.init_moe(jax.random.PRNGKey(0), 32, 16, 8, 1, jnp.float32)
save("p/", p)
for name, shape in SHAPES.items():
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(np.float32)
    res[f"x/{name}"] = x
    for cf in FACTORS:
        cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv=2,
                         d_ff=0, vocab=64, n_experts=8, top_k=2, d_expert=16,
                         n_shared_experts=1, capacity_factor=cf, param_dtype="float32",
                         compute_dtype="float32")
        ep = jax.jit(lambda pp, xx: moe_lib.apply_moe_ep(pp, xx, cfg, mesh))
        res[f"out/{name}/{cf}"] = np.asarray(ep(p, x))
        flat = x.reshape(-1, 32)
        whole = jax.jit(lambda pp, xx: moe_lib.apply_moe(pp, xx, 2, cf))
        res[f"whole/{name}/{cf}"] = np.asarray(whole(p, flat)).reshape(shape)
        half = shape[0] // 2
        res[f"per_shard/{name}/{cf}"] = np.concatenate(
            [np.asarray(whole(p, x[i * half:(i + 1) * half].reshape(-1, 32))).reshape(
                (half,) + shape[1:]) for i in range(2)])
        loss = lambda pp, xx: jnp.sum(moe_lib.apply_moe_ep(pp, xx, cfg, mesh) ** 2)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        save(f"grad/{name}/{cf}/", gp)
        res[f"grad/{name}/{cf}/x"] = np.asarray(gx)

for d_ff in (64, 30):
    mp = swiglu_init(jax.random.PRNGKey(3), 32, d_ff, jnp.float32)
    save(f"mlp{d_ff}/", mp)
    x = res["x/full"]
    res[f"mlp{d_ff}/out"] = np.asarray(jax.jit(
        lambda pp, xx: moe_lib.apply_mlp_ep(pp, xx, None, mesh))(mp, x))
    res[f"mlp{d_ff}/plain"] = np.asarray(jax.jit(swiglu_apply)(mp, x))

for arch in LAYER_ARCHS:
    cfg = configs.reduced(configs.get(arch))
    params = M.init_params(cfg, jax.random.PRNGKey(1))
    layer = jax.tree.map(lambda t: t[0], params["blocks"])
    save(f"block/{arch}/p/", layer)
    x = np.random.default_rng(7).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    res[f"block/{arch}/x"] = x
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    w = tf.layer_windows(cfg)[0]

    def block(pp, xx):
        with use_mesh(mesh):
            return tf.block_forward(pp, cfg, xx, pos, w)[0]

    res[f"block/{arch}/out"] = np.asarray(jax.jit(block)(layer, x))
np.savez(sys.argv[1], **res)
""" % (SHAPES, FACTORS, LAYER_ARCHS, LAYER_TOKENS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep") / "oracle.npz"
    run_oracle(_SCRIPT, 8, out)
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _nest(ref: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` as a nested dict of tensors."""
    return nested(ref, prefix, lambda a: torch.from_numpy(np.array(a)))


def _mesh():
    return tmc.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)


def _cfg(cf):
    return tconfigs.ArchConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                               n_kv=2, d_ff=0, vocab=64, n_experts=8, top_k=2, d_expert=16,
                               n_shared_experts=1, capacity_factor=cf, param_dtype="float32",
                               compute_dtype="float32")


def _of_max(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want))
    return float((got.detach() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_moe_ep_matches_reference(ref, shape, cf):
    p, x = _nest(ref, "p/"), torch.from_numpy(ref[f"x/{shape}"])
    got = tmoe.apply_moe_ep(p, x, _cfg(cf), _mesh())
    assert got.shape == x.shape and _of_max(got, ref[f"out/{shape}/{cf}"]) <= RTOL_OF_MAX


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_moe_ep_is_apply_moe_per_data_shard(ref, shape, cf):
    """Each data shard's capacity comes from its own tokens: the port's EP
    equals ``apply_moe`` over each shard's tokens, its kept pairs those of
    ``apply_moe`` run per shard, exactly."""
    p, x = _nest(ref, "p/"), torch.from_numpy(ref[f"x/{shape}"])
    got, kept = tmoe.apply_moe_ep(p, x, _cfg(cf), _mesh(), return_kept=True)
    half = x.shape[0] // 2
    want, want_kept = zip(*(tmoe.apply_moe(p, x[i * half:(i + 1) * half].reshape(-1, 32), 2, cf,
                                           return_kept=True) for i in range(2)))
    assert torch.equal(kept, torch.cat(want_kept))
    assert _of_max(got.reshape(-1, 32), torch.cat(want)) <= RTOL_OF_MAX
    assert _of_max(got, ref[f"per_shard/{shape}/{cf}"]) <= RTOL_OF_MAX


def test_capacity_binds_per_shard_not_over_the_batch(ref):
    """At cf 1.25 the reference's EP is not ``apply_moe`` over the whole
    batch, and neither is the port's; at cf 8.0 (no drop) both are."""
    p, x = _nest(ref, "p/"), torch.from_numpy(ref["x/full"])
    got = tmoe.apply_moe_ep(p, x, _cfg(1.25), _mesh())
    assert _of_max(got, ref["whole/full/1.25"]) > 1e-2
    assert _of_max(torch.from_numpy(ref["out/full/1.25"]), ref["whole/full/1.25"]) > 1e-2
    no_drop = tmoe.apply_moe_ep(p, x, _cfg(8.0), _mesh())
    assert _of_max(no_drop, ref["whole/full/8.0"]) <= RTOL_OF_MAX


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_moe_ep_gradients_match_reference(ref, shape, cf):
    p = _nest(ref, "p/")
    flat = leaves(p)
    for t in flat.values():
        t.requires_grad_()
    x = torch.from_numpy(ref[f"x/{shape}"]).requires_grad_()
    (tmoe.apply_moe_ep(p, x, _cfg(cf), _mesh()) ** 2).sum().backward()
    want = _nest(ref, f"grad/{shape}/{cf}/")
    assert _of_max(x.grad, want.pop("x")) <= RTOL_OF_MAX
    want = leaves(want)
    assert set(want) == set(flat)
    for name, g in want.items():
        assert _of_max(flat[name].grad, g) <= RTOL_OF_MAX, name


@pytest.mark.parametrize("d_ff", (64, 30))
def test_apply_mlp_ep_matches_reference(ref, d_ff):
    """d_ff 64: tensor-parallel over 4 shards of 16 columns; d_ff 30 does
    not divide, and both packages fall back to ``swiglu_apply``."""
    p, x = _nest(ref, f"mlp{d_ff}/"), torch.from_numpy(ref["x/full"])
    p = {k: p[k] for k in ("gate", "up", "down")}
    got = tmoe.apply_mlp_ep(p, x, None, _mesh())
    assert _of_max(got, ref[f"mlp{d_ff}/out"]) <= RTOL_OF_MAX
    assert _of_max(got, swiglu_apply(p, x)) <= RTOL_OF_MAX
    if d_ff % 4:
        assert torch.equal(got, swiglu_apply(p, x))
    # decode: a sequence of 1 does not split over 'model': swiglu_apply
    x1 = torch.from_numpy(ref["x/decode"])
    assert torch.equal(tmoe.apply_mlp_ep(p, x1, None, _mesh()), swiglu_apply(p, x1))


@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_moe_block_forward_under_a_mesh_matches_reference(ref, arch):
    """A reduced MoE config's first layer under the mesh: ``apply_moe_auto``
    takes the expert-parallel path in both packages."""
    cfg = tconfigs.reduced(tconfigs.get(arch))
    layer = _nest(ref, f"block/{arch}/p/")
    x = torch.from_numpy(ref[f"block/{arch}/x"])
    B, S = LAYER_TOKENS
    pos = torch.arange(S).expand(B, S)
    w = ttf.layer_windows(cfg)[0]
    with tmc.use_mesh(_mesh()):
        got, _ = ttf.block_forward(layer, cfg, x, pos, w)
    assert _of_max(got, ref[f"block/{arch}/out"]) <= RTOL_OF_MAX
    calls = []
    real = tmoe.apply_moe_ep
    try:
        tmoe.apply_moe_ep = lambda *a, **k: calls.append(1) or real(*a, **k)
        with tmc.use_mesh(_mesh()):
            ttf.block_forward(layer, cfg, x, pos, w)
    finally:
        tmoe.apply_moe_ep = real
    assert calls == [1]

