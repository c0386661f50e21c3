"""The port's MoE layer on the CPU against the JAX package's, float32: the
same parameters (``init_moe`` of the reference, carried across as numpy)
and the same numpy tokens go through both.

Tolerances: outputs within 1e-5 (a few float32 matmuls of size-1 values,
summed in another order than XLA:CPU's); the kept (token, expert) pairs
exact: they are integers, and ``apply_moe``'s and
``_local_dispatch_combine``'s come from their own index plumbing, held
against a numpy copy of the capacity rule applied to the reference's own
routing. Capacity factor 0.5 drops assignments, 1.25 (the configs' published
factor) may, 8.0 (``reduced``'s) drops none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import base as jconfigs
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe

ATOL = 1e-5
# the reference's layer functions, compiled once per shape (eager jnp
# compiles every primitive on its own, several times slower here)
j_apply_moe = jax.jit(jmoe.apply_moe, static_argnums=(2, 3))
j_local = jax.jit(jmoe._local_dispatch_combine, static_argnums=(2, 3, 5, 6))
MOE_ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")
FACTORS = (0.5, 1.25, 8.0)


def _port(p):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in p.items()}


def _layer(d, f, E, n_shared, seed=0):
    """The reference's MoE parameters and the port's copy."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, E, n_shared, jnp.float32)
    return jp, _port(jp)


def _tokens(T, d, seed=1):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


def _ref_kept(router, x, top_k, cf):
    """The kept assignments (T, E) of the reference's routing (its float32
    softmax and ``lax.top_k``) under the capacity rule, in numpy: stable
    sort by expert, rank within the expert, rank < C."""
    T, E = x.shape[0], router.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, eidx = jax.lax.top_k(probs, top_k)
    flat_e = np.asarray(eidx).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    rank = np.arange(se.size) - np.searchsorted(se, se, side="left")
    C = max(int(T * top_k / E * cf), top_k)
    kept = np.zeros((T, E), bool)
    tok = np.repeat(np.arange(T), top_k)[order]
    kept[tok[rank < C], se[rank < C]] = True
    return kept


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference(arch, cf):
    cfg = tconfigs.reduced(tconfigs.get(arch))
    jp, tp = _layer(cfg.d_model, cfg.d_expert, cfg.n_experts, cfg.n_shared_experts)
    x = _tokens(96, cfg.d_model)
    got, kept = tmoe.apply_moe(tp, torch.from_numpy(x), cfg.top_k, cf, return_kept=True)
    _close(got, j_apply_moe(jp, jnp.asarray(x), cfg.top_k, cf))
    want_kept = _ref_kept(jp["router"], x, cfg.top_k, cf)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    n_drop = x.shape[0] * cfg.top_k - int(want_kept.sum())
    assert n_drop > 0 if cf == 0.5 else n_drop == 0 if cf == 8.0 else True, n_drop


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_local_dispatch_combine_matches_both_packages(arch, cf):
    """The expert-parallel local step over all E experts, plus the shared
    expert, is ``apply_moe`` of either package; its kept pairs are
    ``apply_moe``'s; the reference's own local step agrees too."""
    cfg = tconfigs.reduced(tconfigs.get(arch))
    E = cfg.n_experts
    jp, tp = _layer(cfg.d_model, cfg.d_expert, E, cfg.n_shared_experts, seed=2)
    x = _tokens(64, cfg.d_model, seed=3)
    xt = torch.from_numpy(x)
    local, kept = tmoe._local_dispatch_combine(tp, xt, cfg.top_k, cf, 0, E, E, return_kept=True)
    _close(local, j_local(jp, jnp.asarray(x), cfg.top_k, cf, 0, E, E))
    if "shared" in tp:
        local = local + tmoe._shared(tp["shared"], xt)
    whole, whole_kept = tmoe.apply_moe(tp, xt, cfg.top_k, cf, return_kept=True)
    _close(local, whole)
    _close(local, j_apply_moe(jp, jnp.asarray(x), cfg.top_k, cf))
    np.testing.assert_array_equal(kept.numpy(), whole_kept.numpy())


@pytest.mark.parametrize("cf", (1.25, 8.0))
def test_expert_ranges_add_up_to_the_layer(cf):
    """Four ranges of two of eight experts each (the expert-parallel split
    over a 'model' axis of 4), summed, plus the shared expert once, give
    the whole layer; each range's part is the reference's."""
    E, E_loc, k = 8, 2, 2
    jp, tp = _layer(32, 16, E, 1, seed=4)
    x = _tokens(64, 32, seed=5)
    xt = torch.from_numpy(x)
    parts = []
    for e0 in range(0, E, E_loc):
        # a shard's parameters: the router whole, its experts' slice
        sl = lambda p: {n: p[n] if n == "router" else p[n][e0:e0 + E_loc]
                        for n in ("router", "gate", "up", "down")}
        part = tmoe._local_dispatch_combine(sl(tp), xt, k, cf, e0, E, E_loc)
        _close(part, j_local(sl(jp), jnp.asarray(x), k, cf, e0, E, E_loc))
        parts.append(part)
    total = sum(parts) + tmoe._shared(tp["shared"], xt)
    _close(total, tmoe.apply_moe(tp, xt, k, cf))


@pytest.mark.parametrize("shape", [(4, 16, 32), (8, 1, 32)], ids=["full_seq", "decode"])
def test_moe_ep_forward_cases_on_one_device(shape):
    """The forward cases of tests/test_moe_ep.py (E 8, k 2, one shared
    expert, cf 8.0, full sequence and decode) through ``apply_moe_auto``,
    against the reference's ``apply_moe``."""
    cfg = tconfigs.ArchConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                              n_kv=2, d_ff=0, vocab=64, n_experts=8, top_k=2, d_expert=16,
                              n_shared_experts=1, capacity_factor=8.0,
                              param_dtype="float32", compute_dtype="float32")
    jp, tp = _layer(32, 16, 8, 1)
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
    got = tmoe.apply_moe_auto(tp, torch.from_numpy(x), cfg)
    want = j_apply_moe(jp, jnp.asarray(x).reshape(-1, 32), 2, 8.0).reshape(shape)
    _close(got, want)


def test_drops_add_nothing_at_expert_zero():
    """At cf 0.5 many assignments drop; each adds a zero at expert 0's
    slot 0, so the token kept there keeps its value (an indexed assignment
    would overwrite it with a zero)."""
    jp, tp = _layer(16, 8, 2, 0, seed=6)
    x = _tokens(32, 16, seed=7)
    got, kept = tmoe.apply_moe(tp, torch.from_numpy(x), 1, 0.5, return_kept=True)
    assert 0 < int(kept.sum()) < 32
    _close(got, j_apply_moe(jp, jnp.asarray(x), 1, 0.5))
    dropped = ~kept.any(1)
    assert bool((got[dropped] == 0).all()) and bool((got[~dropped] != 0).any())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_router_stays_float32(arch):
    """In a bf16 config the router is float32, on the port's own init and
    through ``convert`` from the reference's, and the experts bf16."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = tconfigs.reduced(tconfigs.get(arch), **over)
    jcfg = jconfigs.reduced(jconfigs.get(arch), **over)
    mine = TM.init_params(tcfg, 0, "cpu")
    jparams = jax.jit(JM.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    theirs = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                           "cpu")
    for params in (mine, theirs):
        for blk in params["blocks"]:
            assert blk["moe"]["router"].dtype == torch.float32
            assert blk["moe"]["gate"].dtype == torch.bfloat16
            assert blk["attn"]["wq"].dtype == torch.bfloat16
    # routing runs in float32 on bf16 tokens: the same experts as the
    # reference's bf16 layer picks
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = _port(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp))
    tp = {k: v if k == "router" else
          ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()} if isinstance(v, dict)
           else v.to(torch.bfloat16)) for k, v in tp.items()}
    x = _tokens(48, tcfg.d_model, seed=8)
    xb = jnp.asarray(x, jnp.bfloat16)
    _, kept = tmoe.apply_moe(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg.top_k, 1.25,
                             return_kept=True)
    np.testing.assert_array_equal(
        kept.numpy(), _ref_kept(jp["router"], np.asarray(xb, np.float32), tcfg.top_k, 1.25))
    got = tmoe.apply_moe(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg.top_k, 1.25)
    want = j_apply_moe(jp, xb, tcfg.top_k, 1.25)
    # bf16 matmuls and sums of k + 1 terms of up to the largest output's
    # size, rounded in another order (an output near 0 may be a
    # cancellation of such terms): within 4 bf16 ulps of that size, 2^-5
    want = np.asarray(want, np.float32)
    _close(got.float(), want, atol=2.0 ** -5 * float(np.abs(want).max()))
