"""The port's Mamba-2 SSD block on the CPU against the JAX package's,
float32: the same numpy inputs and the reference's parameters
(``init_mamba2``, carried across as numpy) go through both.

Tolerance: 1e-5 of the reference output's largest magnitude (float32
sums of a chunk's terms in another order than XLA:CPU's; the states grow
to ~30-50, the outputs stay ~1-5); ``_segsum``'s -inf above the diagonal
exact. The chunk-size invariance is the reference's own test
(``tests/test_arch_smoke.py::test_mamba2_chunked_equals_small_chunk``,
2e-3) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import base as jconfigs
from repro.models import ssm as jssm
from repro_torch.configs import base as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

RTOL_OF_MAX = 1e-5


def _close(got, want, scale=RTOL_OF_MAX):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=scale * max(float(np.abs(want).max()), 1.0))


def _rng(seed):
    return np.random.default_rng(seed)


def _cfg(**over):
    return tconfigs.reduced(tconfigs.get("mamba2-780m"), **over)


def _params(cfg, seed=0):
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), cfg, jnp.float32)
    # the reference's zero inits (conv_b, norm) and constant dt_bias would
    # leave their terms untested: random values in both packages
    r = _rng(seed + 100)
    for name in ("conv_b", "norm", "dt_bias"):
        jp[name] = jnp.asarray(0.3 * r.standard_normal(jp[name].shape), jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _scan_inputs(seed, B=2, S=32, H=3, P=4, N=5):
    r = _rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def test_segsum_matches():
    x = _rng(0).standard_normal((2, 3, 8)).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_scan_matches(chunk, with_h0):
    x, dt, A, Bm, Cm = _scan_inputs(1)
    h0 = _rng(2).standard_normal((2, 3, 4, 5)).astype(np.float32) if with_h0 else None
    y, h = tssm.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk,
                         None if h0 is None else torch.from_numpy(h0))
    jy, jh = jssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                           None if h0 is None else jnp.asarray(h0))
    _close(y, jy)
    _close(h, jh)


def test_ssd_scan_refuses_a_ragged_sequence():
    x, dt, A, Bm, Cm = _scan_inputs(3, S=24)
    with pytest.raises(AssertionError):
        tssm.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 16)


def test_causal_conv_matches():
    r = _rng(4)
    x, w, b = (r.standard_normal(s).astype(np.float32) for s in ((2, 11, 6), (4, 6), (6,)))
    got = tssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b))))


def test_apply_mamba2_with_state_matches():
    cfg = _cfg()
    jp, tp = _params(cfg)
    x = _rng(5).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    out, cache = tssm.apply_mamba2(tp, torch.from_numpy(x), cfg, return_state=True)
    jout, jcache = jssm.apply_mamba2(jp, jnp.asarray(x), cfg, return_state=True)
    _close(out, jout)
    _close(cache["conv"], jcache["conv"])
    _close(cache["state"], jcache["state"])
    _close(tssm.apply_mamba2(tp, torch.from_numpy(x), cfg), jout)


def test_apply_mamba2_decode_matches():
    """Eight decode steps from a random cache, each step's output and new
    cache against the reference's step on the same cache."""
    cfg = _cfg()
    jp, tp = _params(cfg, seed=1)
    r = _rng(6)
    B = 3
    tcache = tssm.init_mamba2_cache(cfg, B, torch.float32, "cpu")
    tcache = {k: torch.from_numpy(r.standard_normal(tuple(v.shape)).astype(np.float32))
              for k, v in tcache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in tcache.items()}
    for _ in range(8):
        x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        out, tcache = tssm.apply_mamba2_decode(tp, torch.from_numpy(x), tcache, cfg)
        jout, jcache = jssm.apply_mamba2_decode(jp, jnp.asarray(x), jcache, cfg)
        _close(out, jout)
        for k in ("conv", "state"):
            _close(tcache[k], jcache[k])
        assert tcache["state"].dtype == torch.float32


def test_decode_continues_the_full_sequence():
    """apply_mamba2 over S tokens equals apply_mamba2 over the first S - 16
    with its state handed to 16 decode steps (the port alone)."""
    cfg = _cfg()
    _, tp = _params(cfg, seed=2)
    x = torch.from_numpy(_rng(7).standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    full = tssm.apply_mamba2(tp, x, cfg)
    _, cache = tssm.apply_mamba2(tp, x[:, :48], cfg, return_state=True)
    for i in range(48, 64):
        out, cache = tssm.apply_mamba2_decode(tp, x[:, i:i + 1], cache, cfg)
        _close(out[:, 0], full[:, i].numpy(), scale=1e-4)


def test_mamba2_chunked_equals_small_chunk():
    """SSD invariance to the chunk size (the reference's test, on the
    port): the same parameters at chunk 8 and 16."""
    cfg8, cfg16 = _cfg(ssm_chunk=8), _cfg(ssm_chunk=16)
    params = TM.init_params(cfg8, 6, "cpu")
    toks = torch.from_numpy(_rng(8).integers(0, cfg8.vocab, (2, 32)))
    l8 = TM.forward(params, cfg8, {"tokens": toks})
    l16 = TM.forward(params, cfg16, {"tokens": toks})
    np.testing.assert_allclose(l8.numpy(), l16.numpy(), atol=2e-3)


def test_bf16_config_keeps_the_ssm_scalars_float32():
    """A_log, D and dt_bias are float32 in a bf16 config, as the
    reference's; the rest is bf16; the SSD runs in bf16 and decode stores
    its state in the cache's dtype."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    for arch in ("mamba2-780m", "hymba-1.5b"):
        cfg = tconfigs.reduced(tconfigs.get(arch), **over)
        jcfg = jconfigs.reduced(jconfigs.get(arch), **over)
        p = TM.init_params(cfg, 0, "cpu")["blocks"][0]["ssm"]
        jp = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
        for name, t in p.items():
            want = torch.float32 if name in ("A_log", "D", "dt_bias") else torch.bfloat16
            assert t.dtype == want, (arch, name, t.dtype)
            assert str(jp[name].dtype) == str(want).split(".")[-1], (name, jp[name].dtype)
        # linspace and log round differently in the two packages: an ulp
        np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]), atol=1e-6, rtol=0)
        x = torch.randn(1, 16, cfg.d_model, generator=torch.Generator().manual_seed(0))
        out, cache = tssm.apply_mamba2(p, x.to(torch.bfloat16), cfg, return_state=True)
        assert out.dtype == cache["state"].dtype == torch.bfloat16
        _, cache = tssm.apply_mamba2_decode(p, x[:, :1].to(torch.bfloat16), cache, cfg)
        assert cache["state"].dtype == torch.bfloat16
