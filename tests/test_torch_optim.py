"""The port's optimizer substrate on the CPU against the JAX package:
``repro_torch.optim.adamw`` (schedule, global norm, AdamW) and
``repro_torch.optim.compression`` (int8 with error feedback), on the same
numpy trees.

Tolerances. float32: params, m and v within 1e-6 of each leaf's largest
magnitude (one update is a few float32 operations a leaf, but the two
frameworks may round pow, sqrt and the global norm's sum a bit apart, and
a moment that nearly cancels, b1 m + (1 - b1) g, carries that absolute
error into a small value: elementwise it reads up to 4e-5 relative).
bf16 leaves or moments: equal, except where the float32 results straddle
a bf16 rounding boundary, and then by one bf16 ulp at most; at most 1% of
the elements. Compression: the int8 codes equal except where corrected /
scale lies within 1e-5 of a half-integer (a rounding tie), scales within
1e-7 relative, residuals within 1e-6 of the scale where the codes agree,
wire bytes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.optim import adamw as jadamw
from repro.optim import compression as jgc
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tgc

F32_RTOL = 1e-6
BF16_ULP = 2.0 ** -7           # relative spacing of bf16 just above a power of two
BF16_TIE_SHARE = 0.01
SCALE_RTOL = 1e-7
TIE_WINDOW = 1e-5
SHAPES = {"w": (16, 32), "b": (32,), "deep": {"x": (6, 8, 4), "y": (3, 5)}}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree(seed, shapes=SHAPES, scale=1.0):
    """A numpy float32 tree of ``shapes``."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return draw(shapes)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _hold(got, want, dtype):
    """Every leaf of ``got`` (port) against ``want`` (reference)."""
    for g, w in zip(_leaves(got), _leaves(want)):
        g, w = _to_np(g), _to_np(w)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_RTOL * float(np.abs(w).max()))
            continue
        diff = g != w
        assert diff.mean() <= BF16_TIE_SHARE, f"{diff.sum()} of {diff.size} bf16 values differ"
        np.testing.assert_allclose(g[diff], w[diff], rtol=BF16_ULP, atol=0)


def test_schedule_matches_reference():
    cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100, min_lr_ratio=0.1)
    tcfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100, min_lr_ratio=0.1)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jadamw.schedule(cfg, jnp.asarray(steps)))
    got = tadamw.schedule(tcfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)
    assert float(tadamw.schedule(tcfg, 7)) == pytest.approx(float(want[7]), rel=F32_RTOL)


def test_global_norm_matches_reference():
    g = _tree(3)
    want = float(jadamw.global_norm(_map(jnp.asarray, g)))
    got = float(tadamw.global_norm(_map(torch.from_numpy, g)))
    assert got == pytest.approx(want, rel=F32_RTOL)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, state_dtype):
    """Three updates from the same params, moments and gradients (some
    large enough to clip), then the states compared leaf by leaf."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=1.0,
              state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p0 = _tree(0)
    jp = _map(lambda a: jnp.asarray(a, jdt), p0)
    tp = _map(lambda a: torch.from_numpy(a).to(tdt), p0)
    jst, tst = jadamw.adamw_init(jcfg, jp), tadamw.adamw_init(tcfg, tp)
    for i in range(3):
        g = _tree(10 + i, scale=0.3 if i else 3.0)  # the first step clips
        # the port's current params and moments, handed to the reference too
        jp = _map(lambda t: jnp.asarray(t.float().numpy(), jdt), tp)
        jst = {"m": _map(lambda t: jnp.asarray(t.float().numpy(), t_dtype(t)), tst["m"]),
               "v": _map(lambda t: jnp.asarray(t.float().numpy(), t_dtype(t)), tst["v"]),
               "step": jnp.asarray(int(tst["step"]), jnp.int32)}
        jp2, jst2 = jadamw.adamw_update(jcfg, _map(lambda a: jnp.asarray(a, jdt), g), jst, jp)
        tp, tst = tadamw.adamw_update(tcfg, _map(lambda a: torch.from_numpy(a).to(tdt), g),
                                      tst, tp)
        _hold(tp, jp2, dtype)
        sdt = state_dtype or dtype
        _hold(tst["m"], jst2["m"], sdt)
        _hold(tst["v"], jst2["v"], sdt)
        assert int(tst["step"]) == int(jst2["step"]) == i + 1
    for leaf in _leaves(tst["m"]):
        assert leaf.dtype == (getattr(torch, state_dtype) if state_dtype else tdt)


def t_dtype(t):
    return jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32


def test_adamw_init_follows_state_dtype():
    tp = _map(lambda a: torch.from_numpy(a).to(torch.bfloat16), _tree(0))
    st = tadamw.adamw_init(tadamw.AdamWConfig(state_dtype="float32"), tp)
    assert all(x.dtype == torch.float32 and not x.any() for x in _leaves(st["m"]))
    st = tadamw.adamw_init(tadamw.AdamWConfig(), tp)
    assert all(x.dtype == torch.bfloat16 for x in _leaves(st["v"]))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


def test_compression_matches_reference():
    """Two rounds through compress, so the second carries a residual."""
    g0 = _tree(0)
    jerr = jgc.init_state(_map(jnp.asarray, g0))
    terr = tgc.init_state(_map(torch.from_numpy, g0))
    for i in range(2):
        g = _tree(20 + i, scale=0.01)
        corrected = [a + np.asarray(e) for a, e in zip(_leaves(g), jax.tree_util.tree_leaves(jerr))]
        jq, jerr = jgc.compress(_map(jnp.asarray, g), jerr)
        tq, terr = tgc.compress(_map(torch.from_numpy, g), terr)
        assert tgc.compressed_bytes(tq) == jgc.compressed_bytes(jq)
        jl = jax.tree_util.tree_leaves(jq, is_leaf=lambda x: isinstance(x, tuple))
        tl = _pairs(tq)
        assert len(jl) == len(tl) == len(corrected)
        for (jc, js), (tc_, ts_), cor, te, je in zip(jl, tl, corrected, _leaves(terr),
                                                      jax.tree_util.tree_leaves(jerr)):
            assert tc_.dtype == torch.int8 and ts_.dtype == torch.float32
            js = float(js)
            assert float(ts_) == pytest.approx(js, rel=SCALE_RTOL)
            jc, tc_ = np.asarray(jc), tc_.numpy()
            differ = jc != tc_
            ratio = np.abs(cor / js)
            assert np.all(np.abs(ratio[differ] - np.floor(ratio[differ]) - 0.5) <= TIE_WINDOW)
            np.testing.assert_allclose(te.numpy()[~differ], np.asarray(je)[~differ], rtol=0,
                                       atol=F32_RTOL * js)
        for a, (jc, js) in zip(_leaves(tgc.decompress(tq)), jl):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(jc, np.float32) * float(js),
                                       rtol=SCALE_RTOL, atol=float(js))


def _pairs(x):
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in _pairs(x[k])]
    return [x]


def test_compression_error_feedback_unbiased():
    """Twin of tests/test_substrate.py's: the accumulated decompressed
    gradients track the true sum within 2%."""
    rng = np.random.default_rng(0)
    g0 = {"w": torch.from_numpy((rng.standard_normal((64, 64)) * 0.01).astype(np.float32))}
    err = tgc.init_state(g0)
    acc_true = np.zeros((64, 64))
    acc_hat = np.zeros((64, 64))
    for i in range(30):
        gi = {"w": torch.from_numpy(
            (np.random.default_rng(i).standard_normal((64, 64)) * 0.01).astype(np.float32))}
        q, err = tgc.compress(gi, err)
        acc_true += gi["w"].numpy()
        acc_hat += tgc.decompress(q)["w"].numpy()
    assert np.abs(acc_hat - acc_true).mean() / np.abs(acc_true).mean() < 0.02


def test_compression_wire_bytes_4x_smaller():
    g = {"w": torch.zeros((128, 128)), "b": torch.zeros(128)}
    q, _ = tgc.compress(g, tgc.init_state(g))
    raw = (128 * 128 + 128) * 4
    assert tgc.compressed_bytes(q) < raw / 3.5
    assert tgc.compressed_bytes(q) == 128 * 128 + 4 + 128 + 4
