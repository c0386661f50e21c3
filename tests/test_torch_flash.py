"""The port's flash attention on the CPU (its plain version) against the JAX
package: the Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.flash_attention_ref``, on the same numpy inputs.

Tolerances: 2e-5 in float32 (the reference's own bar for its kernel
against its oracle; the two sum the scores in another order), 0.05 in
bf16 (the reference's bf16 bar: one bf16 rounding of outputs of size ~1).

Also on the CPU: the head dims the wrapper takes (the multiples of 16 from
16 to 128, on every device), and the float32 kernel's tile schedule
(``f32_schedule``) against a brute-force mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import autotune, ops, ref
from repro_torch.models import attention as tattn

F32_ATOL = 2e-5
BF16_ATOL = 0.05


def _qkv(seed, B, S, H, G, hd):
    rng = np.random.default_rng(np.random.SeedSequence(2029, spawn_key=(seed,)))
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd))]


def _port(arrays, dtype=torch.float32, **kw):
    out = ops.flash_attention(*(torch.from_numpy(a).to(dtype) for a in arrays), **kw)
    return out.float().numpy()


def _check_both(arrays, got, atol, dtype=jnp.float32, window=None, softcap=None):
    jarr = [jnp.asarray(a).astype(dtype) for a in arrays]
    kernel = pallas_flash(*jarr, window=window, softcap=softcap, interpret=True)
    oracle = jref.flash_attention_ref(*jarr, window=window, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32), atol=atol, rtol=0)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("B,S,H,G,hd", [(1, 128, 4, 2, 64), (2, 256, 4, 1, 64),
                                        (1, 256, 8, 8, 128), (2, 512, 2, 1, 64),
                                        (1, 128, 4, 2, 80), (1, 128, 4, 2, 16),
                                        (2, 128, 6, 3, 48), (1, 128, 8, 1, 112)])
def test_plain_flash_matches_reference_shapes(B, S, H, G, hd):
    arrays = _qkv(S + hd, B, S, H, G, hd)
    _check_both(arrays, _port(arrays), F32_ATOL)


@pytest.mark.parametrize("window,softcap", [(128, None), (None, 30.0), (128, 50.0)])
def test_plain_flash_matches_reference_window_softcap(window, softcap):
    arrays = _qkv(5, 1, 256, 4, 2, 64)
    got = _port(arrays, window=window, softcap=softcap)
    _check_both(arrays, got, F32_ATOL, window=window, softcap=softcap)


def test_window_zero_is_global():
    arrays = _qkv(6, 1, 256, 4, 2, 64)
    got = _port(arrays, window=0, softcap=50.0)
    np.testing.assert_array_equal(got, _port(arrays, softcap=50.0))
    _check_both(arrays, got, F32_ATOL, softcap=50.0)


def test_plain_flash_matches_reference_bf16():
    arrays = _qkv(9, 1, 128, 2, 1, 64)
    got = _port(arrays, dtype=torch.bfloat16)
    _check_both(arrays, got, BF16_ATOL, dtype=jnp.bfloat16)


def test_ragged_query_blocks_match_one_block():
    """S not a multiple of the query block: the ragged last block (the
    kernel's case at a 8191-token prompt) gives the function of one block."""
    arrays = _qkv(11, 1, 200, 4, 2, 64)
    t = [torch.from_numpy(a) for a in arrays]
    got = ref.flash_attention_ref(*t, window=64, softcap=50.0, q_block=64).numpy()
    want = jattn.attention(*map(jnp.asarray, arrays), window=jnp.asarray(64),
                           attn_softcap=50.0, q_block=200)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


def test_model_attention_on_the_cpu_is_the_plain_version():
    t = [torch.from_numpy(a) for a in _qkv(12, 1, 64, 4, 2, 16)]
    before = tfa.flash_attention.launches
    got = tattn.attention(*t, window=32, attn_softcap=50.0)
    assert torch.equal(got, ref.flash_attention_ref(*t, window=32, softcap=50.0))
    assert tfa.flash_attention.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(13, 1, 64, 4, 2, 64))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    wide = [torch.from_numpy(a) for a in _qkv(13, 1, 64, 4, 2, 144)]
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(*wide)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, v.transpose(2, 3).contiguous().transpose(2, 3))


def test_tma_rule_is_a_function_of_the_layout():
    """What the bf16 kernel's TMA loads read, as the wrapper decides it on
    the card: a 16-byte-aligned base and batch, seq and head strides that
    are multiples of 16 bytes (a dim of size 1 is never stepped over)."""
    bf = torch.bfloat16
    shape, dense = (2, 200, 8, 128), (200 * 8 * 128, 8 * 128, 128, 1)
    assert tfa.tma_violation(shape, dense, bf, 4096) is None
    assert "base address" in tfa.tma_violation(shape, dense, bf, 4096 + 8)
    # the fused-qkv views: q, k, v of one (B, S, H + 2G, hd) tensor
    fused = (200 * 8 * 128, 8 * 128, 128, 1)
    for first_head in (0, 4, 6):
        assert tfa.tma_violation((2, 200, 2, 128), fused, bf, 4096 + first_head * 256) is None
    # hd 80: 160-byte rows are legal; a 168-byte seq stride is not
    assert tfa.tma_violation((1, 10, 3, 80), (2400, 240, 80, 1), bf, 0) is None
    assert "seq stride" in tfa.tma_violation((1, 10, 1, 80), (840, 84, 80, 1), bf, 0)
    assert "head stride" in tfa.tma_violation((1, 4, 2, 64), (999, 144, 68, 1), bf, 0)
    assert tfa.tma_violation((1, 4, 1, 64), (999, 144, 68, 1), bf, 0) is None
    assert "head dim" in tfa.tma_violation(shape, (0, 0, 1, 128), bf, 0)
    # the tensor maps get dense strides for dims of size 1
    assert tfa.tma_strides((1, 1, 4, 80), (7, 3, 80, 1)) == (320, 320, 80)
    assert tfa.tma_strides(shape, dense) == dense[:3]


def test_tma_rule_binds_only_on_the_card():
    """A bf16 CPU view whose base is off by 8 bytes runs the plain version:
    the rule is the tensor-core kernel's, checked only for CUDA tensors."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(14, 1, 64, 2, 1, 64))
    buf = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    shifted = buf[4:4 + q.numel()].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 == 8
    assert torch.equal(ops.flash_attention(shifted, k, v),
                       ref.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("hd", range(8, 152, 8))
def test_wrapper_takes_exactly_the_legal_head_dims(hd):
    """Every multiple of 16 from 16 to 128 runs (here the plain version);
    any other head dim raises a ValueError that names the rule."""
    arrays = _qkv(15, 1, 40, 4, 2, hd)
    legal = hd % 16 == 0 and 16 <= hd <= 128
    assert (hd in autotune.FLASH_HEAD_DIMS) == legal
    if not legal:
        with pytest.raises(ValueError, match="multiple of 16 from 16 to 128"):
            _port(arrays, window=16, softcap=50.0)
        return
    t = [torch.from_numpy(a) for a in arrays]
    got = ops.flash_attention(*t, window=16, softcap=50.0)
    assert torch.equal(got, ref.flash_attention_ref(*t, window=16, softcap=50.0))


def _seen(S, window, q0, n):
    """The brute-force mask of positions q0..q0+n-1 over keys 0..S-1."""
    pos = np.arange(q0, q0 + n)[:, None]
    key = np.arange(S)[None, :]
    seen = key <= pos
    if window > 0:
        seen &= pos - key < window
    return seen


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 1, 16, 4096])
@pytest.mark.parametrize("S", [1, 77, 4161])
def test_f32_tile_schedule_matches_brute_force_mask(S, window, rep):
    """The float32 kernel's schedule visits every tile that holds an
    unmasked pair of its query tile and no other, and skips the
    per-element mask exactly on the tiles below S that every position of
    the query tile sees whole."""
    groups, heads, bq = tfa.f32_layout(rep)
    assert groups == 1 and heads == rep and bq * rep <= autotune.FLASH_BLOCK_ROWS
    bk = autotune.FLASH_BLOCK_K
    sched = tfa.f32_schedule(S, window, rep)
    assert [q0 for q0, _, _ in sched] == list(range(0, S, bq))
    for q0, n, tiles in sched:
        assert n == min(bq, S - q0)
        seen = _seen(S, window, q0, n)
        want = [k0 for k0 in range(0, S, bk) if seen[:, k0:k0 + bk].any()]
        assert [k0 for k0, _ in tiles] == want, (q0, tiles)
        for k0, masked in tiles:
            whole = k0 + bk <= S and seen[:, k0:k0 + bk].all()
            assert masked == (not whole), (q0, k0, masked)


@pytest.mark.parametrize("rep", [1, 2, 3, 7, 12, 128, 129, 300])
def test_f32_layout_packs_every_query_head(rep):
    """Head groups of at most FLASH_BLOCK_ROWS heads cover the rep query
    heads of a KV head, and a block's rows (positions x heads) fit."""
    groups, heads, bq = tfa.f32_layout(rep)
    assert groups * heads >= rep > (groups - 1) * heads
    assert heads <= autotune.FLASH_BLOCK_ROWS and 1 <= bq
    assert bq * heads <= autotune.FLASH_BLOCK_ROWS < (bq + 1) * heads
