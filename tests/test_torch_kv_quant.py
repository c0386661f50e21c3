"""The port's int8 KV cache (``kv_cache_quant=True``) against the
reference's (tests/test_kv_quant.py), at reduced(stablelm-3b) in float32.

Tolerances: ``quantize_kv`` bit for bit (the same float32 division and
round-half-even); the prefill's int8 cache bit for bit and its scales
within 1e-6 relative (K and V come from matmuls summed in another order
than XLA:CPU's: a value on a rounding boundary could move one step, none
does at these seeds); the int8 decode's logits within 1e-4 of the
reference's serve_step (tests/test_torch_lm.py's bar); the ports of
tests/test_kv_quant.py keep their own bars (one quantisation step, 0.5 on
logits against the float forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import chip_smoke
from repro.configs import base as jconfigs
from repro.models import model as JM
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine, Request

ARCH = "stablelm-3b"
LOGIT_ATOL = 1e-4


def _pair(seed):
    jcfg = jconfigs.reduced(jconfigs.get(ARCH), kv_cache_quant=True)
    tcfg = tconfigs.reduced(tconfigs.get(ARCH), kv_cache_quant=True)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("shape,scale", [((4, 8, 2, 16), 1.0), ((3, 5, 4, 64), 30.0),
                                         ((2, 3, 1, 128), 1e-12)])
def test_quantize_kv_bit_for_bit(shape, scale):
    x = (np.random.default_rng(0).normal(size=shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero head: the scale's floor
    x[..., 1] = np.round(x[..., 1])      # values on the grid
    jq, js = jtf.quantize_kv(jnp.asarray(x))
    tq, ts = ttf.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    back = ttf.dequantize_kv(tq, ts, torch.float32)
    assert np.array_equal(back.numpy(), np.asarray(jtf.dequantize_kv(jq, js, jnp.float32)))


def test_quantize_roundtrip_error_bounded():
    """The reference's test on the port."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8, 2, 16)).astype(np.float32))
    q, s = ttf.quantize_kv(x)
    back = ttf.dequantize_kv(q, s, torch.float32)
    assert q.dtype == torch.int8
    assert float((back - x).abs().max() / x.abs().max()) < 1.5 / 127


def test_init_cache_layout_and_bytes():
    cfg = tconfigs.reduced(tconfigs.get(ARCH), kv_cache_quant=True)
    cache = ttf.init_cache(cfg, 3, 10, torch.float32, "cpu")
    shape = (cfg.n_layers, 3, 10, cfg.n_kv, cfg.hd)
    assert cache["k"].dtype == cache["v"].dtype == torch.int8
    assert tuple(cache["k"].shape) == shape and tuple(cache["k_scale"].shape) == shape[:-1]
    assert cache["k_scale"].dtype == torch.float32 and cache["kpos"].dtype == torch.int32
    plain = ttf.init_cache(tconfigs.reduced(tconfigs.get(ARCH)), 3, 10, torch.bfloat16, "cpu")
    kv = lambda c: sum(c[n].nbytes for n in ("k", "v", "k_scale", "v_scale") if n in c)
    assert kv(cache) * 2 * cfg.hd == kv(plain) * (cfg.hd + 4)
    jcache = jtf.init_cache(jconfigs.reduced(jconfigs.get(ARCH), kv_cache_quant=True), 3, 10,
                            jnp.float32)
    assert sorted(jcache) == sorted(cache)
    for name, t in cache.items():
        assert np.array_equal(t.numpy(), np.asarray(jcache[name])), name


def test_prefill_emits_quantised_cache_like_the_reference():
    jcfg, tcfg, jp, tp = _pair(3)
    toks = _tokens(tcfg.vocab, 2, 8, 4)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert tc["k"].dtype == torch.int8 and tuple(tc["k_scale"].shape) == tuple(tc["k"].shape[:-1])
    assert sorted(tc) == sorted(jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    for name in ("k", "v", "kpos"):
        assert np.array_equal(tc[name].numpy(), np.asarray(jc[name])), name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-6)


def test_int8_decode_matches_reference_serve_step():
    """16 int8 decode steps from an empty cache: logits within 1e-4 of the
    reference's serve_step, the caches' int8 codes equal."""
    jcfg, tcfg, jp, tp = _pair(1)
    B, S = 2, 16
    toks = _tokens(tcfg.vocab, B, S, 2)
    jcache = jtf.init_cache(jcfg, B, S, jnp.float32)
    tcache = ttf.init_cache(tcfg, B, S, torch.float32, "cpu")
    step = jax.jit(lambda c, t, p: JM.serve_step(jp, jcfg, c, t, p))
    for pos in range(S):
        jl, jcache = step(jcache, jnp.asarray(toks[:, pos:pos + 1]), jnp.asarray(pos))
        tl, tcache = TM.serve_step(tp, tcfg, tcache, torch.from_numpy(toks[:, pos:pos + 1]).long(),
                                   pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"pos {pos}")
    for name in ("k", "v", "kpos"):
        assert np.array_equal(tcache[name].numpy(), np.asarray(jcache[name])), name


def test_int8_decode_tracks_forward():
    """The reference's test on the port: the int8 decode within 0.5 of the
    float forward's logits, greedy decisions essentially unchanged."""
    _, tcfg, _, tp = _pair(1)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(tcfg.vocab, B, S, 2)).long()
    full = TM.forward(tp, tcfg, {"tokens": toks})
    cache = ttf.init_cache(tcfg, B, S, torch.float32, "cpu")
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    errs, agree = [], 0
    for pos in range(S):
        lg, cache = TM.serve_step(tp, tcfg, cache, toks[:, pos:pos + 1], pos)
        errs.append(float((lg - full[:, pos]).abs().max()))
        agree += int(bool((lg.argmax(-1) == full[:, pos].argmax(-1)).all()))
    assert max(errs) < 0.5, max(errs)
    assert agree >= S - 1


def test_engine_runs_on_the_int8_cache():
    """The Engine passes the int8 cache through: greedy tokens equal the
    reference engine's, and a reused slot's invalidation resets only
    kpos."""
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import Request as JRequest

    jcfg, tcfg, jp, tp = _pair(5)
    prompts = [_tokens(tcfg.vocab, 1, n, 10 + n)[0].tolist() for n in (3, 5, 4)]
    jeng = JEngine(jcfg, jp, slots=2, cache_len=16)
    teng = Engine(tcfg, tp, slots=2, cache_len=16, device="cpu")
    jreqs = [JRequest(prompt=p, max_new_tokens=4) for p in prompts]
    treqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run()
    teng.run()
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert teng.cache["k"].dtype == torch.int8
    k_before = teng.cache["k"].clone()
    teng._reset_slot(0)
    assert torch.equal(teng.cache["k"], k_before)
    assert bool((teng.cache["kpos"][:, 0] == ttf.EMPTY_KPOS).all())


def test_one_code_flip_stays_under_chip_smoke_bar():
    """chip_smoke.py's reduced_lm phase holds the card's int8 decode to the
    CPU's at REDUCED_LOGIT_ATOL + INT8_FLIP_LOGIT per int8 code that
    differs between them. At that config (reduced(stablelm-3b), its seed
    and tokens), moving any one of 24 sampled codes of the prefill's cache
    by one step moves the decode's logits by at most half of
    INT8_FLIP_LOGIT."""
    cfg = tconfigs.reduced(tconfigs.get(chip_smoke.REDUCED_INT8_ARCH), kv_cache_quant=True)
    params = TM.init_params(cfg, chip_smoke.LM_SEED, "cpu")
    rng = np.random.default_rng(np.random.SeedSequence(
        chip_smoke.LM_SEED, spawn_key=(len(chip_smoke.REDUCED_ARCHS),)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, chip_smoke.REDUCED_TOKENS))
    steps, S = chip_smoke.REDUCED_INT8_STEPS, toks.shape[1]
    _, cache = TM.prefill(params, cfg, {"tokens": toks})

    def decode(c):
        c = chip_smoke.pad_cache(torch, ttf, c, steps)
        out = []
        for i in range(steps):
            lg, c = TM.serve_step(params, cfg, c, toks[:, i:i + 1], S + i)
            out.append(lg)
        return torch.stack(out)

    base = decode(cache)
    _, want, _ = chip_smoke.prefill_then_decode(torch, TM, ttf, params, cfg, toks, steps)
    assert torch.equal(base, want)
    pick = np.random.default_rng(0)
    worst = 0.0
    for trial in range(24):
        c = {k: v.clone() for k, v in cache.items()}
        name = ("k", "v")[trial % 2]
        idx = tuple(int(pick.integers(0, n)) for n in c[name].shape)
        code = int(c[name][idx])
        c[name][idx] = code + (1 if code < 127 else -1)
        worst = max(worst, float((decode(c) - base).abs().max()))
    assert 0.0 < worst <= chip_smoke.INT8_FLIP_LOGIT / 2, worst
