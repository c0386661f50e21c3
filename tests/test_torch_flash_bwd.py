"""The gradient of the port's flash attention on the CPU.

``ref.flash_attention_bwd_ref`` is the plain version of the backward
kernels (``csrc/flash_attention_bwd.cu``): the same formulas step by step
from the forward's row log-sum-exp (D = rowsum(dO o), P, dV, dP, dS with
the softcap's derivative, dQ, dK, GQA sums). It is held
against autograd through the port's plain forward, against ``jax.vjp`` of
the reference's ``repro.models.attention.attention`` on the same numpy
inputs (the reference takes this gradient by autodiff), and, wired into
``models.attention.FlashAttention``, by ``torch.autograd.gradcheck`` in
float64.

Tolerance: 1e-5 of each gradient's largest magnitude in float32 (the
formulas add in another order than autodiff does: readings ~1e-7);
float64 against autograd 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import autotune, ops, ref
from repro_torch.models import attention as tattn

F32_RTOL_OF_MAX = 1e-5
F64_RTOL_OF_MAX = 1e-12
# (B, S, H, G, hd), window, softcap: causal, window, softcap, rep 1 / 2 / 4,
# a ragged S (not a multiple of the 256-row query block)
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
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd), (B, S, H, hd))]


def _close(got, want, rtol_of_max):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_of_max * np.abs(want).max())


@pytest.mark.parametrize("shape,window,softcap", CASES)
def test_bwd_ref_matches_autograd_of_the_plain_forward(shape, window, softcap):
    for dtype, tol in ((torch.float32, F32_RTOL_OF_MAX), (torch.float64, F64_RTOL_OF_MAX)):
        q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(shape, 1))
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = ref.flash_attention_ref(*qkv, window=window, softcap=softcap, q_block=64,
                                         return_lse=True)
        want = torch.autograd.grad(o, qkv, do)
        got = ref.flash_attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do, window=window,
                                          softcap=softcap)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            _close(g.numpy(), w.numpy(), tol)


@pytest.mark.parametrize("shape,window,softcap", CASES)
def test_bwd_ref_matches_jax_vjp_of_the_reference(shape, window, softcap):
    q, k, v, do = _inputs(shape, 2)
    w = None if window is None else jnp.asarray(window, jnp.int32)
    # the reference's query blocks must divide S: 100 at the ragged 300
    qb = 100 if shape[1] % 256 and shape[1] > 256 else 256
    fn = lambda q, k, v: jattn.attention(q, k, v, causal=True, window=w, attn_softcap=softcap,
                                         q_block=qb)
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    _, lse = ref.flash_attention_ref(*t, window=window, softcap=softcap, return_lse=True)
    got = ref.flash_attention_bwd_ref(*t, torch.from_numpy(np.array(o)), lse,
                                      torch.from_numpy(do), window=window, softcap=softcap)
    for g, wnt in zip(got, want):
        _close(g.numpy(), np.asarray(wnt), F32_RTOL_OF_MAX)


@pytest.mark.parametrize("shape,window,softcap", [
    ((1, 7, 2, 1, 4), None, None), ((2, 9, 4, 2, 4), 3, 5.0), ((1, 12, 4, 4, 8), 0, None),
])
def test_flash_attention_function_gradcheck(shape, window, softcap):
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(shape, 3, np.float64))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tattn.FlashAttention.apply(q, k, v, window, softcap), (q, k, v))


def test_attention_takes_the_function_only_for_a_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 32, 4, 2, 16), 4))
    plain = tattn.attention(q, k, v, window=8, attn_softcap=50.0)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert tattn.attention(q.requires_grad_(True), k, v).grad_fn is None
    o = tattn.attention(q, k, v, window=8, attn_softcap=50.0)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(o.detach(), plain)  # the CPU forward's values do not change
    (dq,) = torch.autograd.grad(o, q, do)
    lse = ref.flash_attention_ref(q.detach(), k, v, window=8, softcap=50.0, return_lse=True)[1]
    want = ref.flash_attention_bwd_ref(q.detach(), k, v, plain, lse, do, window=8,
                                       softcap=50.0)[0]
    assert torch.equal(dq, want)


def test_wrapper_on_the_cpu_is_the_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 40, 4, 2, 16), 5))
    o, lse = ops.flash_attention(q, k, v, window=10, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, window=10)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=10)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # window <= 0 is global, as in the forward
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    for g, w in zip(ops.flash_attention_bwd(q, k, v, o, lse, do, window=0),
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, do)):
        assert torch.equal(g, w)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 16, 4, 2, 16), 6))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q[..., :8], k[..., :8], v[..., :8], o[..., :8], lse, do[..., :8])
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention_bwd(q, k, v, o[:, :8], lse, do)
    with pytest.raises(ValueError, match="does not match"):
        fa.flash_attention_bwd(q, k, v, o, lse, do.double())
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q.double(), k.double(), v.double(), o.double(), lse.double(),
                               do.double())
    with pytest.raises(ValueError, match="KV heads"):
        fa.flash_attention_bwd(q[:, :, :3], k, v, o[:, :, :3], lse, do[:, :, :3])
    with pytest.raises(ValueError, match="not contiguous"):
        t = do.transpose(1, 3).contiguous().transpose(1, 3)
        fa.flash_attention_bwd(q, k, v, o, lse, t)
    # the lse: (B, H, S), the computing type, contiguous
    for bad in (lse[:, :, :8], lse.double(), lse.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            fa.flash_attention_bwd(q, k, v, o, bad, do)


def test_bwd_ref_bf16_rounds_float32_gradients_once():
    """bf16 inputs: the plain version computes in float32 and rounds each
    gradient once, so it equals the float32 gradient of the same (bf16)
    values, rounded."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((1, 64, 4, 2, 16), 7))
    o, lse = ref.flash_attention_ref(q, k, v, softcap=50.0, return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=50.0)
    want = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                       softcap=50.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


# ---------------------------------------------------- the float32 kernels' walks
# global, a few windows, and the windows whose edges fall on a tile edge:
# 2 (the last query a 128-key block sees ends a 64-query tile), 65 (the
# first key a 128-position block sees starts a 64-key tile) and 191 (a tile
# seen whole up to the window's last pair)
WALK_WINDOWS = [0, 2, 16, 65, 191, 1024]
def _visible(S, window):
    """The brute-force mask over (query, key) positions 0..S-1."""
    query = np.arange(S)[:, None]
    key = np.arange(S)[None, :]
    seen = key <= query
    if window > 0:
        seen &= query - key < window
    return seen


@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("window", WALK_WINDOWS)
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000])
def test_bwd_f32_dkdv_walk_matches_brute_force_mask(S, window, rep):
    """The dK/dV kernel's walk (each block of keys over the rep query heads
    of its KV head and the query tiles that see it) covers every visible
    (head, query, key) triple exactly once; no query tile it skips holds a
    visible pair of the block, none it visits holds none; and "unmasked"
    is set only on tiles where every pair of the block's keys and the
    tile's queries is visible and below S."""
    bk, bt = autotune.FLASH_BWD_BLOCK_ROWS, autotune.FLASH_BWD_TILE_ROWS
    seen = _visible(S, window)
    walk = fa.bwd_f32_schedule(S, window, rep)["dkdv"]
    assert [(k0, n) for k0, n, _ in walk] == [(k0, min(bk, S - k0)) for k0 in range(0, S, bk)]
    count = np.zeros((rep, S, S), np.int64)
    for k0, n, tiles in walk:
        keys = slice(k0, k0 + n)
        for r in range(rep):
            visited = [q0 for rr, q0, _ in tiles if rr == r]
            want = [q0 for q0 in range(0, S, bt) if seen[q0:q0 + bt, keys].any()]
            assert visited == want, (k0, r, visited)
        for r, q0, masked in tiles:
            count[r, q0:q0 + bt, keys] += 1
            if not masked:
                assert q0 + bt <= S and k0 + bk <= S and seen[q0:q0 + bt, k0:k0 + bk].all()
    assert (count[:, seen] == 1).all() and count.max() <= 1


@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("window", WALK_WINDOWS)
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000])
def test_bwd_f32_dq_walk_matches_brute_force_mask(S, window, rep):
    """The dQ kernel's walk (each block of packed rows: the positions of a
    tile times all rep query heads of a KV head, over the key tiles its
    rows see) covers every visible (head, query, key) triple exactly once;
    no key tile it skips holds a visible pair of the block, none it visits
    holds none; and "unmasked" is set only on tiles where every position
    of the block sees every key of the tile, below S."""
    bt = autotune.FLASH_BWD_TILE_ROWS
    groups, heads, bq = fa.f32_layout(rep, autotune.FLASH_BWD_BLOCK_ROWS)
    assert groups == 1 and heads == rep and bq * rep <= autotune.FLASH_BWD_BLOCK_ROWS
    seen = _visible(S, window)
    walk = fa.bwd_f32_schedule(S, window, rep)["dq"]
    assert [(q0, n) for q0, n, _ in walk] == [(q0, min(bq, S - q0)) for q0 in range(0, S, bq)]
    count = np.zeros((S, S), np.int64)
    for q0, n, tiles in walk:
        rows = slice(q0, q0 + n)
        want = [k0 for k0 in range(0, S, bt) if seen[rows, k0:k0 + bt].any()]
        assert [k0 for k0, _ in tiles] == want, (q0, tiles)
        for k0, masked in tiles:
            count[rows, k0:k0 + bt] += 1
            if not masked:
                assert k0 + bt <= S and seen[rows, k0:k0 + bt].all()
    # every block holds all rep heads of its positions: each head's count
    # is this one
    assert (count[seen] == 1).all() and count.max() <= 1
