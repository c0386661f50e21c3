"""The port's serving path for the MoE, SSM, hybrid, vlm and audio families
on the CPU against the JAX package, float32, at the reduced configs: the
same parameters (``convert.params_from_reference``) and the same numpy
tokens (and, for vlm, patch embeddings) go through both.

Tolerances, as ``tests/test_torch_lm.py``'s: 1e-4 on logits of forward,
prefill and 16 decode steps; caches within 1e-5 of their largest
magnitude (K and V ~5, the SSM state ~50); kpos exact; 5e-3 for decode
against forward (the reference's own bar, ``tests/test_arch_smoke.py``);
M-RoPE within 1e-6 (one rotation in float32); greedy tokens exact, except
at a near tie of the reference's logits (gap <= 1e-4). The SSM configs'
margin under 1e-4 is thinner than the others': each package's mamba2
layer is ~1e-5 from a float64 run, and the next layer amplifies that
about tenfold, so the logits of reduced(mamba2-780m) read 6.1e-5 apart
here and 1.1e-4 with the same parameters drawn under ``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import base as jconfigs
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import convert
from repro_torch.configs import base as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine, Request

LOGIT_ATOL = 1e-4
CACHE_RTOL_OF_MAX = 1e-5
DECODE_VS_FORWARD = 5e-3
MROPE_ATOL = 1e-6
TIE_GAP = 1e-4
# the reference's forward for the greedy tie checks, compiled once per
# config and shape (eager jnp compiles every primitive on its own)
j_forward = jax.jit(JM.forward, static_argnums=1)
FAMILIES = ("dbrx-132b", "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b", "qwen2-vl-7b",
            "musicgen-medium")


def _pair(arch, seed=0, **overrides):
    """A reduced config, the reference's parameters and the port's copy."""
    jcfg = jconfigs.reduced(jconfigs.get(arch), **overrides)
    tcfg = tconfigs.reduced(tconfigs.get(arch), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _batches(cfg, B, S, seed=1):
    """The same batch for both packages: tokens and, for vlm, patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "vlm":
        pe = rng.standard_normal((B, cfg.n_patches, TM.PATCH_DIM)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    return jb, tb


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _close_cache(got, want):
    want = np.asarray(want, np.float32)
    _close(got, want, CACHE_RTOL_OF_MAX * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_prefill_match(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batches(tcfg, 2, 32)
    _close(TM.forward(tp, tcfg, tb), JM.forward(jp, jcfg, jb), LOGIT_ATOL)
    lg, cache = TM.prefill(tp, tcfg, tb)
    jlg, jcache = JM.prefill(jp, jcfg, jb)
    _close(lg, jlg, LOGIT_ATOL)
    assert sorted(cache) == sorted(jcache)
    for name, t in cache.items():
        if name == "kpos":
            np.testing.assert_array_equal(t.numpy(), np.asarray(jcache[name]))
        else:
            _close_cache(t, jcache[name])


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_steps_match(arch):
    """16 decode steps from an empty cache, per-row positions (vlm: the
    reference's (pos, pos, pos))."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=2)
    B, S, cache_len = 2, 16, 16
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jcache = jtf.init_cache(jcfg, B, cache_len, jnp.float32)
    tcache = ttf.init_cache(tcfg, B, cache_len, torch.float32, "cpu")
    assert sorted(tcache) == sorted(jcache)
    jstep = jax.jit(lambda c, t, p: JM.serve_step(jp, jcfg, c, t, p))
    for pos in range(S):
        jlg, jcache = jstep(jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.full((B,), pos, jnp.int32))
        tlg, tcache = TM.serve_step(tp, tcfg, tcache, torch.from_numpy(toks[:, pos:pos + 1]).long(),
                                    torch.full((B,), pos))
        _close(tlg, jlg, LOGIT_ATOL)
    for name, t in tcache.items():
        if name == "kpos":
            np.testing.assert_array_equal(t.numpy(), np.asarray(jcache[name]))
        else:
            _close_cache(t, jcache[name])


@pytest.mark.parametrize("arch", [a for a in FAMILIES if a != "qwen2-vl-7b"])
def test_decode_matches_forward(arch):
    """Serve steps from an empty cache against forward's logits at each
    position (tests/test_arch_smoke.py; vlm's decode positions are not
    forward's, ROADMAP Queue 3, item 10)."""
    _, tcfg, _, tp = _pair(arch, seed=1)
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (B, S)))
    full = TM.forward(tp, tcfg, {"tokens": toks})
    cache = ttf.init_cache(tcfg, B, S, torch.float32, "cpu")
    err = 0.0
    for pos in range(S):
        lg, cache = TM.serve_step(tp, tcfg, cache, toks[:, pos:pos + 1], pos)
        err = max(err, float((lg - full[:, pos]).abs().max()))
    assert err < DECODE_VS_FORWARD, err


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b", "dbrx-132b"])
def test_prefill_then_decode_continues(arch):
    """prefill(S - 16) hands its cache (SSM state and conv window, K/V
    padded) to 16 serve steps, each against forward(S) at its position."""
    _, tcfg, _, tp = _pair(arch, seed=3)
    B, S, n = 2, 48, 16
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab, (B, S)))
    full = TM.forward(tp, tcfg, {"tokens": toks})
    _, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, :S - n]})
    pad = {"kpos": ttf.EMPTY_KPOS}
    cache = {k: v if k in ttf.SSM_CACHE else
             torch.cat([v, torch.full_like(v[:, :, :n], pad.get(k, 0))], dim=2)
             for k, v in cache.items()}
    for pos in range(S - n, S):
        lg, cache = TM.serve_step(tp, tcfg, cache, toks[:, pos:pos + 1], pos)
        assert float((lg - full[:, pos]).abs().max()) < DECODE_VS_FORWARD


def test_apply_mrope_matches():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 7, 3)).astype(np.int32)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 2, 2), 1e4)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2), 1e4)
    _close(got, want, MROPE_ATOL)
    # one stream on all three is apply_rope
    same = np.repeat(pos[..., :1], 3, axis=-1)
    _close(tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), (4, 2, 2)),
           tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0])), MROPE_ATOL)


def test_mrope_positions_match():
    for cfg in (tconfigs.reduced(tconfigs.get("qwen2-vl-7b")), tconfigs.get("qwen2-vl-7b")):
        jcfg = jconfigs.get(cfg.name) if "smoke" not in cfg.name else \
            jconfigs.reduced(jconfigs.get("qwen2-vl-7b"))
        S = cfg.n_patches + 20
        np.testing.assert_array_equal(TM._positions(cfg, 2, S, "cpu").numpy(),
                                      np.asarray(JM._positions(jcfg, 2, S)))


def test_vlm_prefill_then_serve_step_matches_reference():
    """vlm: prefill over patches + text, then 4 serve steps, both packages
    with the reference's decode positions (pos, pos, pos)."""
    jcfg, tcfg, jp, tp = _pair("qwen2-vl-7b", seed=4)
    jb, tb = _batches(tcfg, 2, 24, seed=6)
    jlg, jcache = JM.prefill(jp, jcfg, jb)
    tlg, tcache = TM.prefill(tp, tcfg, tb)
    S = tcfg.n_patches + 24
    n = 4
    pad = lambda c, fill: jnp.concatenate([c, jnp.full_like(c[:, :, :n], fill)], axis=2)
    jcache = {k: pad(v, 2**30 if k == "kpos" else 0) for k, v in jcache.items()}
    tcache = {k: torch.cat([v, torch.full_like(v[:, :, :n], ttf.EMPTY_KPOS if k == "kpos" else 0)],
                           dim=2) for k, v in tcache.items()}
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (2, n)).astype(np.int32)
    for i in range(n):
        jlg, jcache = JM.serve_step(jp, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]), S + i)
        tlg, tcache = TM.serve_step(tp, tcfg, tcache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                    S + i)
        _close(tlg, jlg, LOGIT_ATOL)


def _same_greedy(jp, jcfg, prompt, got, want):
    """Token for token, unless the reference's logits tie within TIE_GAP
    where the two first differ (then the rest need not agree)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            seq = list(prompt) + list(want[:i])
            logits = np.asarray(j_forward(jp, jcfg, {"tokens": jnp.asarray([seq])})[0, -1],
                                np.float32)
            gap = float(logits[b] - logits[a])
            assert gap <= TIE_GAP, f"token {i}: port {a}, reference {b}, gap {gap}"
            return


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b", "dbrx-132b"])
def test_engine_greedy_matches_reference(arch):
    """5 requests over 2 slots: three requests reuse a slot, whose SSM
    state and conv window the engine zeroes first."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=5)
    specs = [([3 + i, 7, 11 + 2 * i][: 1 + i % 3], 3 + i % 2) for i in range(5)]
    jeng = JEngine(jcfg, jp, slots=2, cache_len=16)
    teng = Engine(tcfg, tp, slots=2, cache_len=16, device="cpu")
    jreqs = [JRequest(prompt=p, max_new_tokens=n) for p, n in specs]
    treqs = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert teng.steps_run == jeng.steps_run
    for t, j, (p, n) in zip(treqs, jreqs, specs):
        assert t.done and len(t.out) == n
        _same_greedy(jp, jcfg, p, t.out, j.out)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_engine_resets_a_reused_slot(arch):
    """A request in a reused slot gives the tokens and logits it gives in a
    fresh engine, and the reset zeroes exactly that slot's SSM rows."""
    _, tcfg, _, tp = _pair(arch, seed=6)
    first, second = [5, 9, 2, 8], [4, 1, 6]

    def run(prompts):
        eng = Engine(tcfg, tp, slots=1, cache_len=16, device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs[-1].out, eng.last_logits

    reused, reused_logits = run([first, second])
    fresh, fresh_logits = run([second])
    assert reused == fresh
    _close(reused_logits, fresh_logits, 1e-6)
    eng = Engine(tcfg, tp, slots=3, cache_len=16, device="cpu")
    for name in ttf.SSM_CACHE:
        eng.cache[name].fill_(1.0)
    eng._reset_slot(1)
    for name in ttf.SSM_CACHE:
        assert bool((eng.cache[name][:, 1] == 0).all())
        assert bool((eng.cache[name][:, [0, 2]] == 1).all())


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b",
                                  "qwen2-vl-7b", "musicgen-medium", "gemma2-27b", "stablelm-3b",
                                  "qwen2-72b", "starcoder2-15b"])
def test_every_family_initialises(arch):
    """``check_supported`` accepts every family; ``init_params`` runs for
    each reduced config and gives the reference's parameter tree."""
    tcfg = tconfigs.reduced(tconfigs.get(arch))
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    ttf.check_supported(tcfg)
    mine = TM.init_params(tcfg, 0, "cpu")
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}/").items()}
        return {prefix: tree}

    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in flat(shapes).items()}
    got = flat({k: v for k, v in mine.items() if k != "blocks"})
    got.update({f"blocks/{k}": t for k, t in flat(mine["blocks"][0]).items()})
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        shape, dtype = want[k]
        if k.startswith("blocks/"):  # the reference stacks the layers
            shape = shape[1:]
        assert tuple(t.shape) == shape and str(t.dtype).split(".")[-1] == dtype, (k, t.shape)


def test_cli_no_smoke_serves_the_full_config(monkeypatch):
    """--no-smoke leaves the config unreduced (init_params stubbed: no
    full-width weights are made); the default still reduces it."""
    seen = []

    class Stop(Exception):
        pass

    def fake_init(cfg, seed, dev):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(tserve.M, "init_params", fake_init)
    for argv, full in ((["--arch", "mamba2-780m", "--no-smoke"], True),
                       (["--arch", "mamba2-780m", "--smoke"], False),
                       (["--arch", "mamba2-780m"], False)):
        with pytest.raises(Stop):
            tserve.main(argv + ["--device", "cpu"])
        assert (seen[-1] == tconfigs.get("mamba2-780m")) == full, argv
        assert seen[-1].name.endswith("-smoke") != full
