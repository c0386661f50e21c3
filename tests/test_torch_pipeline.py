"""The port's GPipe pipeline and the transformer's mesh knobs on the CPU
against the JAX package's on 4 host devices (``tests/test_pipeline.py``'s
twin, with its gradient taken under ``jax.jit``).

One subprocess computes every reference case at once:

- ``pipeline_forward`` of ``reduced(stablelm-3b)`` at 8 layers, 4 stages on
  the 'model' axis, B 4, S 16, 2 microbatches, and the gradient of the sum
  of its squared output with respect to every block leaf;
- ``model.forward`` of reduced dense configs under a (data 2, model 2)
  mesh with each knob (``attn_head_parallel``, ``pure_dp``, ``mlp_ep``)
  set, and with none.

The port runs on ``["cpu"] * 4``. Bars: the pipeline within 2e-4 of the
reference's (the reference's own bar against ``stack_forward``; it reads
4.1e-5), each gradient leaf within 1e-4 of its largest magnitude; the
knobs ``attn_head_parallel`` and ``pure_dp`` only hint placement, so the
port's output with either is its output without, bit for bit, and
``mlp_ep`` sums the tensor-parallel partials in another order (1e-5 of the
largest magnitude); every knob's logits within 1e-4 of the reference's
with the same knob.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_oracle import leaves, nested, record_hints, run_oracle
from repro_torch import convert
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import pipeline as tpp
from repro_torch.models import transformer as ttf
from repro_torch.train import meshctx as tmc

PIPE = dict(arch="stablelm-3b", n_layers=8, B=4, S=16, n_micro=2, stages=4)
PIPE_ATOL = 2e-4
GRAD_RTOL_OF_MAX = 1e-4
KNOB_ARCHS = ("stablelm-3b", "gemma2-27b")
KNOBS = ("attn_head_parallel", "pure_dp", "mlp_ep")
KNOB_TOKENS = (4, 16)
LOGIT_ATOL = 1e-4
MLP_EP_RTOL_OF_MAX = 1e-5

_SCRIPT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import base as configs
from repro.models import model as M, pipeline as PP, transformer as tf
from repro.train.meshctx import use_mesh

PIPE, KNOB_ARCHS, KNOBS, (KB, KS) = %r, %r, %r, %r
res = {}


def save(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        res[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


cfg = configs.reduced(configs.get(PIPE["arch"]), n_layers=PIPE["n_layers"])
params = M.init_params(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh((PIPE["stages"],), ("model",))
B, S = PIPE["B"], PIPE["S"]
x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
pipe = lambda p, xx: PP.pipeline_forward(p, cfg, xx, positions, mesh, n_micro=PIPE["n_micro"])
save("pipe/p/", params["blocks"])
res["pipe/x"] = x
res["pipe/out"] = np.asarray(jax.jit(pipe)(params["blocks"], x))
res["pipe/stack"] = np.asarray(jax.jit(
    lambda p, xx: tf.stack_forward(p, cfg, xx, positions))(params["blocks"], x))
save("pipe/grad/", jax.jit(jax.grad(lambda p: jnp.sum(pipe(p, x) ** 2)))(params["blocks"]))

# Auto axes (jax.sharding.Mesh's default): the reference's constrain hands
# with_sharding_constraint specs that jax 0.9.0 refuses on the Explicit axes
# jax.make_mesh makes
mesh2 = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for arch in KNOB_ARCHS:
    cfg = configs.reduced(configs.get(arch))
    params = M.init_params(cfg, jax.random.PRNGKey(2))
    save(f"knob/{arch}/p/", params)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (KB, KS)).astype(np.int32)
    res[f"knob/{arch}/tokens"] = toks
    for knob in (None,) + KNOBS:
        ck = cfg if knob is None else dataclasses.replace(cfg, **{knob: True})

        def fwd(p, t):
            with use_mesh(mesh2):
                return M.forward(p, ck, {"tokens": t})

        res[f"knob/{arch}/{knob}"] = np.asarray(jax.jit(fwd)(params, toks))
np.savez(sys.argv[1], **res)
""" % (PIPE, KNOB_ARCHS, KNOBS, KNOB_TOKENS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline") / "oracle.npz"
    run_oracle(_SCRIPT, 4, out)
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _pipe_inputs(ref):
    cfg = tconfigs.reduced(tconfigs.get(PIPE["arch"]), n_layers=PIPE["n_layers"])
    blocks = convert.params_from_reference(cfg, {"blocks": nested(ref, "pipe/p/")}, "cpu")["blocks"]
    x = torch.from_numpy(ref["pipe/x"])
    B, S = x.shape[:2]
    return cfg, blocks, x, torch.arange(S).expand(B, S)


def _stages(n: int = PIPE["stages"]):
    return tmc.make_mesh((n,), ("model",), ["cpu"] * n)


def test_pipeline_forward_matches_reference(ref):
    cfg, blocks, x, pos = _pipe_inputs(ref)
    got = tpp.pipeline_forward(blocks, cfg, x, pos, _stages(), PIPE["n_micro"])
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref["pipe/out"], atol=PIPE_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref["pipe/stack"], atol=PIPE_ATOL, rtol=0)


def test_pipeline_forward_is_stack_forward_over_its_microbatches(ref):
    """The same blocks on the same microbatches in the same order: the
    pipeline is ``stack_forward`` of each microbatch, bit for bit."""
    cfg, blocks, x, pos = _pipe_inputs(ref)
    for n_micro in (1, 2, 4):
        Bm = x.shape[0] // n_micro
        want = torch.cat([ttf.stack_forward(blocks, cfg, xm, pos[:Bm]) for xm in x.split(Bm)])
        for stages in (1, 2, 4, 8):
            got = tpp.pipeline_forward(blocks, cfg, x, pos, _stages(stages), n_micro)
            assert torch.equal(got, want), (n_micro, stages)


def test_pipeline_gradients_match_reference(ref):
    cfg, blocks, x, pos = _pipe_inputs(ref)
    flat = leaves(blocks)
    for t in flat.values():
        t.requires_grad_()
    (tpp.pipeline_forward(blocks, cfg, x, pos, _stages(), PIPE["n_micro"]) ** 2).sum().backward()
    want = leaves(convert.params_from_reference(
        cfg, {"blocks": nested(ref, "pipe/grad/")}, "cpu")["blocks"])
    assert set(want) == set(flat)
    for name, g in want.items():
        got = flat[name].grad
        assert got is not None, name
        err = float((got - g).abs().max() / g.abs().max())
        assert err <= GRAD_RTOL_OF_MAX, (name, err)


@pytest.mark.parametrize("n_micro", (1, 2, 3, 5))
@pytest.mark.parametrize("stages", (1, 2, 4))
def test_schedule_is_the_reference_active_set(stages, n_micro):
    """The reference runs every stage at each of its n_micro + S - 1 ticks
    and keeps stage s's result at tick t where m = t - s lies in [0,
    n_micro) (``src/repro/models/pipeline.py``, ``tick``): that set, in
    tick order, with every microbatch through every stage once, stage s
    one tick after stage s - 1."""
    want = {(t, s, t - s) for t in range(n_micro + stages - 1) for s in range(stages)
            if 0 <= t - s < n_micro}
    got = tpp.schedule(stages, n_micro)
    assert set(got) == want and len(got) == stages * n_micro
    assert [t for t, _, _ in got] == sorted(t for t, _, _ in got)
    tick = {(s, m): t for t, s, m in got}
    assert all(tick[(s, m)] == tick[(s - 1, m)] + 1 for s in range(1, stages)
               for m in range(n_micro))


def test_pipeline_refuses_indivisible_layers_and_batches(ref):
    cfg, blocks, x, pos = _pipe_inputs(ref)
    with pytest.raises(ValueError):
        tpp.pipeline_forward(blocks, cfg, x, pos, _stages(3), 2)  # 8 layers, 3 stages
    with pytest.raises(ValueError):
        tpp.pipeline_forward(blocks, cfg, x, pos, _stages(4), 3)  # batch 4, 3 microbatches


def _knob_run(ref, arch, knob, mesh=True):
    cfg = tconfigs.reduced(tconfigs.get(arch))
    if knob is not None:
        cfg = dataclasses.replace(cfg, **{knob: True})
    params = convert.params_from_reference(cfg, nested(ref, f"knob/{arch}/p/"), "cpu")
    batch = {"tokens": torch.from_numpy(ref[f"knob/{arch}/tokens"]).long()}
    if not mesh:
        return TM.forward(params, cfg, batch)
    with tmc.use_mesh(tmc.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)):
        return TM.forward(params, cfg, batch)


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("arch", KNOB_ARCHS)
def test_mesh_knobs_match_reference(ref, arch, knob, monkeypatch):
    plain = _knob_run(ref, arch, None, mesh=False)
    log = record_hints(monkeypatch)
    got = _knob_run(ref, arch, knob)
    if knob == "mlp_ep":
        assert float((got - plain).abs().max() / plain.abs().max()) <= MLP_EP_RTOL_OF_MAX
    else:
        assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), ref[f"knob/{arch}/{knob}"], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(plain.numpy(), ref[f"knob/{arch}/None"], atol=LOGIT_ATOL, rtol=0)
    # the hints the knob adds (per layer: q, k, v and o, and the residual
    # after attention; every layer ends with the carry's hint)
    n_layers = tconfigs.reduced(tconfigs.get(arch)).n_layers
    per_layer = {"attn_head_parallel": 6, "pure_dp": 1, "mlp_ep": 1}[knob]
    assert len(log) == per_layer * n_layers
    if knob == "pure_dp":
        assert all(spec == tmc.P(("data", "model"), None, None) for _, spec in log)


@pytest.mark.parametrize("arch", KNOB_ARCHS)
def test_a_mesh_without_knobs_moves_no_value(ref, arch, monkeypatch):
    plain = _knob_run(ref, arch, None, mesh=False)
    log = record_hints(monkeypatch)
    got = _knob_run(ref, arch, None)
    assert torch.equal(got, plain) and len(log) == tconfigs.reduced(tconfigs.get(arch)).n_layers
    assert all(spec == tmc.P("data", "model", None) for _, spec in log)
