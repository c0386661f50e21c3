"""The row log-sum-exp that the port's flash forward writes, and the
gradient that the backward takes from it, on the CPU.

``ref.flash_attention_ref(..., return_lse=True)`` is the plain version of
what both forward kernels (``csrc/flash_attention.cu``) write beside o:
each row's log-sum-exp of its visible scores, in natural-log units. It is
held to a float64 numpy log-sum-exp of the same inputs at 1e-6 relative,
and 1e-6 absolute where |lse| < 1 (the scores, of size ~1-10, round to
float32 before the sum, ~1e-7 absolute; a row's lse can pass through 0,
where a relative bar alone would ask for more); the wrapper on the
CPU returns the same pair from its one call, and o with or without the lse
is the same bits. ``models.attention.FlashAttention`` saves that lse and
hands it to the backward: the gradient of ``attention`` is held to
``jax.vjp`` of the reference's ``repro.models.attention.attention`` on the
same numpy inputs at 1e-5 of each gradient's largest magnitude, and to
``torch.autograd.gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

LSE_RTOL = 1e-6
LSE_ATOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-5
# (B, S, H, G, hd), window, softcap: tests/test_torch_flash_bwd.py's cases
# (causal, window, softcap, rep 1 / 2 / 4, a ragged S)
CASES = [
    ((2, 64, 2, 2, 16), None, None),
    ((1, 96, 4, 2, 16), 16, None),
    ((2, 48, 4, 1, 32), None, 50.0),
    ((1, 80, 8, 2, 16), 24, 5.0),
    ((1, 300, 4, 4, 16), None, None),
    ((1, 300, 4, 1, 16), 100, 30.0),
]


def _inputs(shape, seed, dtype=np.float32):
    B, S, H, G, hd = shape
    rng = np.random.default_rng(np.random.SeedSequence(2031, spawn_key=(seed, S, H)))
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd), (B, S, H, hd))]


def _lse_np(q, k, window, softcap):
    """Each row's log-sum-exp of its visible scores, in float64 numpy."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k.astype(np.float64), rep, axis=2)) * hd ** -0.5
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    lag = np.arange(S)[:, None] - np.arange(S)[None, :]
    seen = (lag >= 0) & ((lag < window) if window else True)
    s = np.where(seen, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    return (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("shape,window,softcap", CASES)
def test_plain_lse_matches_float64_logsumexp(shape, window, softcap):
    q, k, v, _ = _inputs(shape, 1)
    o, lse = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=window,
                                     softcap=softcap, q_block=64, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, k, window, softcap), rtol=LSE_RTOL,
                               atol=LSE_ATOL)


def test_wrapper_returns_o_and_lse_from_one_call():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((1, 70, 4, 2, 16), 2))
    o = ops.flash_attention(q, k, v, window=20, softcap=50.0)
    o2, lse = ops.flash_attention(q, k, v, window=20, softcap=50.0, return_lse=True)
    assert torch.equal(o, o2)
    assert torch.equal(lse, ref.flash_attention_ref(q, k, v, window=20, softcap=50.0,
                                                    return_lse=True)[1])
    # float64 inputs (gradcheck's) keep the lse in float64
    _, lse64 = ref.flash_attention_ref(q.double(), k.double(), v.double(), return_lse=True)
    assert lse64.dtype == torch.float64


@pytest.mark.parametrize("shape,window,softcap", CASES)
def test_attention_gradient_through_the_saved_lse_matches_jax_vjp(shape, window, softcap):
    q, k, v, do = _inputs(shape, 3)
    w = None if window is None else jnp.asarray(window, jnp.int32)
    # the reference's query blocks must divide S: 100 at the ragged 300
    qb = 100 if shape[1] % 256 and shape[1] > 256 else 256
    fn = lambda q, k, v: jattn.attention(q, k, v, causal=True, window=w, attn_softcap=softcap,
                                         q_block=qb)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tattn.attention(*qkv, window=window, attn_softcap=softcap)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(saved[4], ref.flash_attention_ref(
        *(t.detach() for t in qkv), window=window, softcap=softcap, return_lse=True)[1])
    got = torch.autograd.grad(o, qkv, torch.from_numpy(do))
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt, np.float64)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=0,
                                   atol=GRAD_RTOL_OF_MAX * np.abs(wnt).max())


@pytest.mark.parametrize("shape,window,softcap", [
    ((1, 10, 4, 2, 4), 4, None), ((2, 8, 2, 2, 8), None, 3.0), ((1, 11, 6, 3, 4), 5, 5.0),
])
def test_gradcheck_with_the_saved_lse(shape, window, softcap):
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(shape, 4, np.float64))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tattn.FlashAttention.apply(q, k, v, window, softcap), (q, k, v))
