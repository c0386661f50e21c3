"""The port's sharded OGASCHED step (paper §3.2, ``repro_torch.core.
distributed``) against the reference's single-device composition, on
several CPU "devices" (a mesh that names the CPU eight times).

Tolerances: the reference's own (tests/test_distributed.py): y within
atol 2e-5, q within rtol 1e-5. On one shard the step is the unsharded
fused step, launch for launch: y bit for bit, q to 1e-6 relative (the gain
and the penalty are summed apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core import graph as jgraph
from repro.core import projection as jproj
from repro.core import reward as jreward
from repro.sched import trace as jtrace
from repro_torch import convert
from repro_torch.core import distributed, ogasched
from repro_torch.kernels import ops

CFG = dict(L=6, R=32, K=4, seed=0)


def _problem():
    """The reference test's spec, y and x (L 6, R 32, K 4), and the port's
    copies."""
    jspec = jtrace.build_spec(jtrace.TraceConfig(**CFG))
    y = jgraph.random_feasible_decision(jspec, jax.random.PRNGKey(0))
    x = (jax.random.uniform(jax.random.PRNGKey(1), (6,)) < 0.7).astype(jnp.float32)
    return (jspec, y, x, convert.spec_from_reference(jspec, "cpu"),
            torch.from_numpy(np.array(y)), torch.from_numpy(np.array(x)))


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_step_matches_single_device_reference(shards):
    jspec, y, x, tspec, ty, tx = _problem()
    eta = 3.0
    mesh = ["cpu"] * shards
    step = distributed.make_distributed_step(tspec, mesh)
    y_next, q = step(distributed.shard_y(ty, mesh), tx, torch.tensor(eta))
    got = distributed.gather_y(y_next)
    q_ref = jreward.total_reward(jspec, x, y)
    y_ref = jproj.project(jspec, y + eta * jreward.reward_grad(jspec, x, y))
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_ref), atol=2e-5, rtol=1e-5)
    assert len(y_next) == shards and all(t.shape == (6, 32 // shards, 4) for t in y_next)


def test_one_shard_is_the_unsharded_fused_step():
    _, _, _, tspec, ty, tx = _problem()
    step = distributed.make_distributed_step(tspec, ["cpu"])
    eta = torch.tensor(3.0)
    (y_next,), q = step(distributed.shard_y(ty, ["cpu"]), tx, eta)
    state, q_ref = ogasched.oga_step(tspec, ogasched.OGAState(y=ty, eta=eta, t=0), tx, 1.0,
                                     backend="fused")
    assert torch.equal(y_next, state.y)
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-6)


def test_explicit_kstar_equals_the_local_one():
    """ops.oga_update_spec(kstar=) given the k* the local y implies is the
    default update bit for bit; another k* gives another update."""
    _, _, _, tspec, ty, tx = _problem()
    want = ops.oga_update_spec(tspec, ty, tx, 3.0, backend="fused")
    kstar = ops.kstar_index(tspec, ty)
    assert torch.equal(ops.oga_update_spec(tspec, ty, tx, 3.0, backend="fused", kstar=kstar),
                       want)
    other = ops.oga_update_spec(tspec, ty, tx, 3.0, backend="fused", kstar=(kstar + 1) % 4)
    assert not torch.equal(other, want)
    with pytest.raises(ValueError, match="kstar"):
        ops.oga_update_spec(tspec, ty, tx, 3.0, backend="reference", kstar=kstar)


def test_shards_split_and_gather():
    _, _, _, tspec, ty, _ = _problem()
    mesh = ["cpu"] * 4
    parts = distributed.shard_spec(tspec, mesh)
    assert [p.R for p in parts] == [8] * 4
    for i, p in enumerate(parts):
        blk = slice(8 * i, 8 * (i + 1))
        assert torch.equal(p.mask, tspec.mask[:, blk]) and torch.equal(p.c, tspec.c[blk])
        assert torch.equal(p.alpha, tspec.alpha[blk]) and torch.equal(p.a, tspec.a)
        assert torch.equal(p.beta, tspec.beta) and torch.equal(p.kinds, tspec.kinds)
    assert torch.equal(distributed.gather_y(distributed.shard_y(ty, mesh)), ty)


def test_instances_must_divide_over_the_mesh():
    _, _, _, tspec, ty, _ = _problem()
    with pytest.raises(ValueError, match="divide"):
        distributed.shard_spec(tspec, ["cpu"] * 3)
    with pytest.raises(ValueError, match="divide"):
        distributed.make_distributed_step(tspec, ["cpu"] * 5)
    with pytest.raises(ValueError, match="divide"):
        distributed.shard_y(ty, ["cpu"] * 3)


def test_no_mesh_means_the_card(monkeypatch):
    """mesh=None resolves to the CUDA card: without one it raises, never
    falling back to the CPU quietly."""
    _, _, _, tspec, ty, _ = _problem()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.make_distributed_step(tspec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.shard_y(ty)
