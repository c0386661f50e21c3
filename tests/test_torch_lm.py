"""The port's LM serving path on the CPU against the JAX package, in float32
at the reduced configs: the same parameters (``convert.
params_from_reference``) and the same numpy tokens go through both.

Tolerances: 1e-4 on logits of forward, prefill and 16 decode steps (the
sums run in another order than XLA:CPU's, over logits of size ~1-30);
1e-5 on the prefill caches k and v (two matmuls and RoPE deep, values of
size ~1); kpos and the layer windows exact; 5e-3 for decode after prefill
against forward (the reference's own bar, ``tests/test_arch_smoke.py``);
greedy tokens exact, except at a near tie of the reference's logits
(gap <= 1e-4, the reference's guard in ``tests/test_substrate.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import convert
from repro_torch.configs import base as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine, Request

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
DECODE_VS_FORWARD = 5e-3
TIE_GAP = 1e-4
ARCHS = ("gemma2-27b", "stablelm-3b")


def _pair(arch, seed=0, **overrides):
    """A reduced config, the reference's parameters and the port's copy."""
    jcfg = jconfigs.reduced(jconfigs.get(arch), **overrides)
    tcfg = tconfigs.reduced(tconfigs.get(arch), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def test_configs_match_the_reference():
    assert tconfigs.names() == jconfigs.names()
    for name in jconfigs.names():
        assert tconfigs.get(name).__dict__ == jconfigs.get(name).__dict__
        assert tconfigs.reduced(tconfigs.get(name)).__dict__ == \
            jconfigs.reduced(jconfigs.get(name)).__dict__


@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-3b", "qwen2-72b", "starcoder2-15b",
                                  "hymba-1.5b"])
def test_layer_windows_match(arch):
    for cfg_t, cfg_j in ((tconfigs.get(arch), jconfigs.get(arch)),
                         (tconfigs.reduced(tconfigs.get(arch)),
                          jconfigs.reduced(jconfigs.get(arch)))):
        assert ttf.layer_windows(cfg_t) == np.asarray(jtf.layer_windows(cfg_j)).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(tcfg.vocab, 2, 32)
    got = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    _close(got, JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}), LOGIT_ATOL)
    lg, cache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    jlg, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(lg, jlg, LOGIT_ATOL)
    _close(cache["k"], jcache["k"], CACHE_ATOL)
    _close(cache["v"], jcache["v"], CACHE_ATOL)
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    assert cache["kpos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match(arch):
    """16 decode steps from an empty cache, per-row positions."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=2)
    B, S, cache_len = 2, 16, 16
    toks = _tokens(tcfg.vocab, B, S, seed=3)
    jcache = jtf.init_cache(jcfg, B, cache_len, jnp.float32)
    tcache = ttf.init_cache(tcfg, B, cache_len, torch.float32, "cpu")
    jstep = jax.jit(lambda c, t, p: JM.serve_step(jp, jcfg, c, t, p))
    for pos in range(S):
        jlg, jcache = jstep(jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.full((B,), pos, jnp.int32))
        tlg, tcache = TM.serve_step(tp, tcfg, tcache, torch.from_numpy(toks[:, pos:pos + 1]).long(),
                                    torch.full((B,), pos))
        _close(tlg, jlg, LOGIT_ATOL)
    np.testing.assert_array_equal(tcache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    _close(tcache["k"], jcache["k"], CACHE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_forward(arch):
    """prefill(S - 1 tokens), pad the cache, one serve_step: the last
    position's logits of forward (tests/test_arch_smoke.py)."""
    _, tcfg, _, tp = _pair(arch, seed=3)
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(tcfg.vocab, B, S, seed=4)).long()
    full = TM.forward(tp, tcfg, {"tokens": toks})
    lg_pre, caches = TM.prefill(tp, tcfg, {"tokens": toks[:, :S - 1]})
    pad = lambda c: torch.cat([c, torch.zeros_like(c[:, :, :1])], dim=2)
    cache = {"k": pad(caches["k"]), "v": pad(caches["v"]),
             "kpos": torch.cat([caches["kpos"], torch.full((tcfg.n_layers, B, 1),
                                                           ttf.EMPTY_KPOS, dtype=torch.int32)], 2)}
    lg, _ = TM.serve_step(tp, tcfg, cache, toks[:, S - 1:], S - 1)
    assert float((lg - full[:, S - 1]).abs().max()) < DECODE_VS_FORWARD
    assert float((lg_pre - full[:, S - 2]).abs().max()) < DECODE_VS_FORWARD


def test_embedding_scale_rounds_in_bf16():
    """gemma2 multiplies by sqrt(d) rounded to the compute dtype: 68.0 at
    d = 4608 in bf16, as the reference does."""
    cfg = tconfigs.reduced(tconfigs.get("gemma2-27b"), d_model=4608, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    params = {"embed": torch.ones(4, 4608, dtype=torch.bfloat16)}
    x = TM.embed_inputs(params, cfg, {"tokens": torch.tensor([[1]])})
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 68.0
    jx = jnp.ones((1,), jnp.bfloat16) * jnp.asarray(4608 ** 0.5, jnp.bfloat16)
    assert float(jx[0]) == 68.0


def test_params_from_reference_carries_bf16_bits():
    jcfg, tcfg, jp, tp = _pair("gemma2-27b", param_dtype="bfloat16", compute_dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16 and len(tp["blocks"]) == tcfg.n_layers
    for i in range(tcfg.n_layers):
        want = np.asarray(jp["blocks"]["attn"]["wq"][i], np.float32)
        np.testing.assert_array_equal(tp["blocks"][i]["attn"]["wq"].float().numpy(), want)
    np.testing.assert_array_equal(tp["unembed"].float().numpy(),
                                  np.asarray(jp["unembed"], np.float32))


def _tiny():
    kw = dict(n_layers=2, d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=64)
    return _pair("stablelm-3b", **kw)


def _ref_gap(jp, jcfg, seq, got, want):
    logits = np.asarray(JM.forward(jp, jcfg, {"tokens": jnp.asarray([seq])})[0, -1], np.float32)
    return float(logits[want] - logits[got])


def _same_greedy(jp, jcfg, prompt, got, want):
    """Token for token, unless the reference's logits tie within TIE_GAP
    where the two first differ (then the rest need not agree)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = _ref_gap(jp, jcfg, list(prompt) + list(want[:i]), a, b)
            assert gap <= TIE_GAP, f"token {i}: port {a}, reference {b}, gap {gap}"
            return


def test_engine_greedy_matches_reference():
    jcfg, tcfg, jp, tp = _tiny()
    specs = [([3, 7, 11], 4), ([5, 2], 4)]
    jeng = JEngine(jcfg, jp, slots=2, cache_len=32)
    teng = Engine(tcfg, tp, slots=2, cache_len=32, device="cpu")
    jreqs = [JRequest(prompt=p, max_new_tokens=n) for p, n in specs]
    treqs = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert teng.steps_run == jeng.steps_run
    for t, j in zip(treqs, jreqs):
        assert t.done and len(t.out) == 4
        _same_greedy(jp, jcfg, t.prompt, t.out, j.out)


def test_engine_continuous_batching_refills():
    jcfg, tcfg, jp, tp = _tiny()
    jeng = JEngine(jcfg, jp, slots=2, cache_len=32)
    teng = Engine(tcfg, tp, slots=2, cache_len=32, device="cpu")
    jreqs = [JRequest(prompt=[i + 1], max_new_tokens=3) for i in range(5)]
    treqs = [Request(prompt=[i + 1], max_new_tokens=3) for i in range(5)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert all(r.done and len(r.out) == 3 for r in treqs)
    for t, j in zip(treqs, jreqs):
        _same_greedy(jp, jcfg, t.prompt, t.out, j.out)


def test_engine_stops_at_eos_and_a_full_cache():
    _, tcfg, _, tp = _tiny()
    eng = Engine(tcfg, tp, slots=1, cache_len=6, device="cpu")
    first = Request(prompt=[1, 2], max_new_tokens=10)
    eng.submit(first)
    eng.run()
    assert first.done and len(first.out) == 5  # positions 0..5 fill the cache
    assert eng.last_logits.shape == (1, tcfg.vocab)
    assert int(eng.last_logits[0].argmax()) == first.out[-1]
    stop = Request(prompt=[1, 2], max_new_tokens=10, eos=first.out[1])
    eng.submit(stop)
    eng.run()
    assert stop.out[-1] == first.out[1] and len(stop.out) <= 2


def test_sampling_is_seeded():
    _, tcfg, _, tp = _tiny()
    outs = []
    for _ in range(2):
        eng = Engine(tcfg, tp, slots=2, cache_len=16, temperature=1.0, seed=7, device="cpu")
        reqs = [Request(prompt=[1, 2], max_new_tokens=5), Request(prompt=[3], max_new_tokens=5)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1] and all(len(o) == 5 for o in outs[0])


def test_cli_runs_on_the_cpu_when_asked(capsys):
    res = tserve.main(["--arch", "gemma2-27b", "--requests", "3", "--max-new", "4",
                       "--slots", "2", "--device", "cpu"])
    assert all(r.done and len(r.out) == 4 for r in res["requests"])
    assert "served 3 requests" in capsys.readouterr().out


def test_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp = _tiny()
    for call in (lambda: TM.init_params(tcfg, 0),
                 lambda: Engine(tcfg, tp),
                 lambda: tserve.main(["--requests", "1"]),
                 lambda: convert.params_from_reference(tcfg, {"blocks": {}})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_options_raise():
    """No option is left unported: the mesh knobs, refused until the
    multi-device modules came, now run, and with no mesh active each is
    the single-device path bit for bit, as in the reference
    (``tests/test_torch_pipeline.py`` holds them under a mesh)."""
    base = tconfigs.reduced(tconfigs.get("stablelm-3b"))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, base.vocab, (2, 16)))
    want = TM.forward(TM.init_params(base, 0, "cpu"), base, {"tokens": tokens})
    for knob in ("attn_head_parallel", "pure_dp", "mlp_ep"):
        cfg = tconfigs.reduced(base, **{knob: True})
        got = TM.forward(TM.init_params(cfg, 0, "cpu"), cfg, {"tokens": tokens})
        assert torch.equal(got, want), knob
