"""Causal GQA flash attention with a sliding window and a logit softcap.

Counterpart of ``repro.kernels.flash_attention``, and of its gradient,
which the reference takes by autodiff of jnp: ``flash_attention_bwd``
wraps the backward kernels of ``csrc/flash_attention_bwd.cu`` (plain
version ``ref.flash_attention_bwd_ref``), three a call
(``BWD_KERNELS``, by dtype). ``flash_attention`` is the wrapper of two
CUDA kernels in ``csrc/flash_attention.cu``: bf16 tensors launch the
tensor-core kernel ``flash_attention_wgmma_kernel``, float32 tensors the
FFMA kernel ``flash_attention_f32_kernel``; CPU tensors compute the plain
version ``ref.flash_attention_ref``. With ``return_lse`` the same launch
also writes each row's log-sum-exp, which the backward reads. Either way
it first checks what the kernels take: float32 or bf16 q, k, v of one
type, q (B, S, H, hd) and k, v (B, S, G, hd) with G dividing H, hd in
``autotune.FLASH_HEAD_DIMS`` (a multiple of 16 from 16 to 128), the head
dim contiguous, and on the card what the kernels' TMA loads need
(``tma_violation``: of q, k and v in bf16, of k and v in float32, whose
forward reads q by plain loads; the backward's of q, k, v, o and dO in
both dtypes). Other strides are read as they are: nothing is transposed
or copied.

Meta tensors (the dry run's, ``launch.dryrun``) take the same checks and
get outputs of the kernels' shapes and dtypes from a custom op that
launches nothing (``repro_torch::flash_attention_meta`` and
``repro_torch::flash_attention_bwd_meta``), whose FLOPs
``torch.utils.flop_counter`` counts by ``analysis.roofline.flash_flops``.

``f32_layout`` and ``f32_schedule`` state, in Python, how the float32
kernel packs the query heads of a KV head into a block and which K/V
tiles each block visits, with or without the per-element mask;
``bwd_f32_schedule`` the same of the float32 backward's two kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis import roofline
from repro_torch.kernels import _launch, autotune, ref

_DTYPES = (torch.float32, torch.bfloat16)


def _argtypes(n_tiles: int) -> tuple:
    """ctypes argument types of a flash C entry with ``n_tiles`` tile
    constants."""
    return ((ctypes.c_void_p,) * 5                      # q, k, v, o, lse (None: none)
            + (ctypes.c_int,) * (5 + n_tiles)            # B, S, H, G, hd, tile constants
            + (ctypes.POINTER(ctypes.c_longlong),)       # 12 strides
            + (ctypes.c_int, ctypes.c_float, ctypes.c_float)  # window, scale, softcap
            + (ctypes.c_void_p,))                        # stream


# the C entry, its argument types and its tile constants, by dtype
_ENTRIES = {
    torch.bfloat16: ("repro_flash_attention_bf16", (
        autotune.FLASH_TC_BLOCK_Q, autotune.FLASH_TC_BLOCK_K, autotune.FLASH_TC_STAGES)),
    torch.float32: ("repro_flash_attention", (
        autotune.FLASH_BLOCK_ROWS, autotune.FLASH_BLOCK_K, autotune.FLASH_STAGES,
        autotune.FLASH_MICRO_ROWS, autotune.FLASH_MICRO_KEYS)),
}
# bytes: TMA reads from a base address and with strides that are multiples
# of this
TMA_ALIGN = 16


def tma_violation(shape: Sequence[int], strides: Sequence[int], dtype: torch.dtype,
                  data_ptr: int) -> Optional[str]:
    """Why the tensor-core kernel's TMA loads cannot read a (B, S, heads,
    hd) tensor of this shape, element strides, dtype and base address, or
    None when they can: the base address and the byte strides of the
    batch, seq and head dims must be multiples of 16 (a dim of size 1 is
    never stepped over, so its stride does not count), and the head dim
    contiguous."""
    size = torch.empty((), dtype=dtype).element_size()
    if data_ptr % TMA_ALIGN:
        return f"base address {data_ptr:#x} is not a multiple of {TMA_ALIGN} bytes"
    if strides[3] != 1:
        return "the head dim is not contiguous"
    for name, n, st in zip(("batch", "seq", "head"), shape[:3], strides[:3]):
        if n > 1 and (st <= 0 or st * size % TMA_ALIGN):
            return (f"the {name} stride is {st * size} bytes, not a positive multiple of "
                    f"{TMA_ALIGN}")
    return None


def tma_strides(shape: Sequence[int], strides: Sequence[int]) -> tuple:
    """The (batch, seq, head) element strides handed to the tensor maps: as
    given, but a dim of size 1 gets its dense stride (any legal value
    would do, since its only index is 0)."""
    return tuple(st if n > 1 else math.prod(shape[i + 1:])
                 for i, (n, st) in enumerate(zip(shape[:3], strides[:3])))


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_by_tma: bool = False) -> None:
    """Raise on anything the kernels do not take. On the card k and v must
    be readable by TMA, and q too in bf16 or with ``q_by_tma`` (the
    backward streams float32 q through a tensor map; the float32 forward
    reads q by plain loads)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    G = k.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"{G} KV heads do not divide {H} query heads")
    if hd not in autotune.FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not taken: the kernels take a multiple of 16 "
                         f"from 16 to 128, {autotune.FLASH_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {_DTYPES}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim is not contiguous")
        if t.device.type == "cuda" and (t.dtype == torch.bfloat16 or q_by_tma or name != "q"):
            why = tma_violation(t.shape, t.stride(), t.dtype, t.data_ptr())
            if why is not None:
                raise ValueError(f"{name}: the {t.dtype} kernel cannot read it: {why}")


def f32_layout(rep: int, rows: int = autotune.FLASH_BLOCK_ROWS) -> tuple:
    """(head groups, heads per block, positions per block) of the float32
    kernel's GQA packing: a block holds ``rows`` query rows
    (FLASH_BLOCK_ROWS; the backward's dQ kernel FLASH_BWD_BLOCK_ROWS), the
    positions of a tile times the heads of a group; the rep query heads of
    a KV head form as few groups as fit (one while rep <= the rows)."""
    groups = -(-rep // rows)
    heads = -(-rep // groups)
    return groups, heads, rows // heads


def f32_schedule(S: int, window: int, rep: int, rows: int = autotune.FLASH_BLOCK_ROWS,
                 bk: int = autotune.FLASH_BLOCK_K) -> list:
    """The float32 kernel's tile schedule, for each query tile in position
    order: (q0, positions, [(k0, masked), ...]). A tile of ``bk`` keys
    from k0 is visited when any position of the query tile (a block of
    ``rows`` packed rows) sees a key in it; ``masked`` is False only where
    every position of the tile sees every key of it (below the diagonal,
    inside the window, below S), and the kernel then skips the
    per-element mask."""
    bq = f32_layout(rep, rows)[2]
    out = []
    for q0 in range(0, S, bq):
        k_end = min(q0 + bq, S)
        k_first = max(0, q0 - window + 1) if window > 0 else 0
        tiles = []
        for k0 in range(k_first // bk * bk, k_end, bk):
            whole = (k0 + bk - 1 <= q0 and k0 + bk <= S
                     and (window <= 0 or k_end - 1 - k0 < window))
            tiles.append((k0, not whole))
        out.append((q0, k_end - q0, tiles))
    return out


def bwd_f32_schedule(S: int, window: int, rep: int) -> dict:
    """The float32 backward's tile walks. "dkdv": for each block of
    FLASH_BWD_BLOCK_ROWS keys from k0 in order, (k0, keys, [(r, q0,
    masked), ...]): for each of the rep query heads r of the KV head, the
    tiles of FLASH_BWD_TILE_ROWS queries from q0 that see the block (from
    the one holding k0 to the one holding the last position within the
    window, below S); ``masked`` is False only where every query of the
    tile (below S) sees every key of the block. "dq": the dQ kernel's walk,
    the forward's (``f32_schedule``) on FLASH_BWD_BLOCK_ROWS packed query
    rows and FLASH_BWD_TILE_ROWS-key tiles, each block holding all rep
    query heads of its positions."""
    bk, bt = autotune.FLASH_BWD_BLOCK_ROWS, autotune.FLASH_BWD_TILE_ROWS
    dkdv = []
    for k0 in range(0, S, bk):
        q_last = min(S - 1, k0 + bk - 2 + window) if window > 0 else S - 1
        tiles = []
        for r in range(rep):
            for q0 in range(k0 // bt * bt, q_last + 1, bt):
                whole = (k0 + bk - 1 <= q0 and q0 + bt <= S
                         and (window <= 0 or q0 + bt - 1 - k0 < window))
                tiles.append((r, q0, not whole))
        dkdv.append((k0, min(bk, S - k0), tiles))
    return {"dkdv": dkdv, "dq": f32_schedule(S, window, rep, bk, bt)}


# ------------------------------------------------------------ meta tensors --
@torch.library.custom_op("repro_torch::flash_attention_meta", mutates_args=())
def _flash_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward's outputs on meta tensors: o like q, and lse (B, H, S)
    (empty without ``return_lse``)."""
    raise ValueError(f"the meta stand-in of flash attention takes meta tensors, not {q.device}")


@_flash_meta.register_fake
def _(q, k, v, window, return_lse):
    B, S, H, _ = q.shape
    lse = q.new_empty((B, H, S) if return_lse else (0,), dtype=ref._acc_dtype(q.dtype))
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


@register_flop_formula(torch.ops.repro_torch.flash_attention_meta)
def _flash_meta_flops(q_shape, k_shape, v_shape, window, return_lse, *args, **kwargs) -> int:
    B, S, H, hd = q_shape
    return roofline.flash_flops(B, S, H, hd, window)


@torch.library.custom_op("repro_torch::flash_attention_bwd_meta", mutates_args=())
def _flash_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's outputs on meta tensors: dq, dk, dv like q, k, v."""
    raise ValueError(f"the meta stand-in of flash attention takes meta tensors, not {q.device}")


@_flash_bwd_meta.register_fake
def _(q, k, v, window):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd_meta)
def _flash_bwd_meta_flops(q_shape, k_shape, v_shape, window, *args, **kwargs) -> int:
    B, S, H, hd = q_shape
    return roofline.flash_flops(B, S, H, hd, window, roofline.BWD_PRODUCTS)


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    softcap: Optional[float] = None, return_lse: bool = False):
    """Causal attention of q (B, S, H, hd) over k, v (B, S, G, hd); query
    head h reads KV head h // (H // G). ``window`` None or <= 0 is global;
    ``softcap`` None is none. Returns (B, S, H, hd) in q's dtype; with
    ``return_lse``, (o, lse): lse (B, H, S) float32 (float64 for float64
    CPU tensors), each row's log-sum-exp of its visible scores, from the
    same launch.

    CUDA tensors: one launch of the bf16 or the float32 kernel, counted in
    ``flash_attention.launches`` and in ``flash_attention.kernel_launches``
    under the dtype's name. CPU tensors: ``ref.flash_attention_ref``. Meta
    tensors: outputs of those shapes and dtypes, nothing launched.
    """
    _check_inputs(q, k, v)
    w = int(window) if window is not None and int(window) > 0 else 0
    if q.device.type == "meta":
        o, lse = _flash_meta(q, k, v, w, return_lse)
        return (o, lse) if return_lse else o
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=w or None, softcap=softcap,
                                       return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    B, S, H, hd = q.shape
    G = k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    dims = [tma_strides(t.shape, t.stride()) for t in (q, k, v, o)]
    strides = (ctypes.c_longlong * 12)(*(st for d in dims for st in d))
    entry, tiles = _ENTRIES[q.dtype]
    fn = _launch.c_entry("flash_attention.cu", entry, _argtypes(len(tiles)))
    _launch.call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, S, H, G, hd, *tiles, strides, w,
                 hd ** -0.5, 0.0 if softcap is None else float(softcap))
    flash_attention.launches += 1
    flash_attention.kernel_launches[_KERNEL_OF[q.dtype]] += 1
    return (o, lse) if return_lse else o


_KERNEL_OF = {torch.bfloat16: "bf16", torch.float32: "float32"}
flash_attention.launches = 0
flash_attention.kernel_launches = {"bf16": 0, "float32": 0}

# CUDA kernels one backward call launches, by dtype: the D pass, dK and dV,
# dQ (bf16 on the tensor cores, float32 in FFMA)
BWD_KERNELS = {
    "bf16": ("flash_bwd_dsum_kernel", "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
    "float32": ("flash_bwd_dsum_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"),
}
# the backward's C entry and tile constants, by dtype
_BWD_ENTRIES = {
    torch.bfloat16: ("repro_flash_attention_bwd_bf16", (
        autotune.FLASH_BWD_TC_BLOCK_ROWS, autotune.FLASH_BWD_TC_TILE_ROWS,
        autotune.FLASH_BWD_TC_STAGES)),
    torch.float32: ("repro_flash_attention_bwd", (
        autotune.FLASH_BWD_BLOCK_ROWS, autotune.FLASH_BWD_TILE_ROWS, autotune.FLASH_BWD_STAGES,
        autotune.FLASH_BWD_MICRO_ROWS, autotune.FLASH_BWD_MICRO_COLS)),
}


def _bwd_argtypes(n_tiles: int) -> tuple:
    """ctypes argument types of a backward C entry with ``n_tiles`` tile
    constants."""
    return ((ctypes.c_void_p,) * 11                    # q k v o lse do dq dk dv lse2 dsum
            + (ctypes.c_int,) * (6 + n_tiles)          # B S H G hd, tile constants, stat_s
            + (ctypes.POINTER(ctypes.c_longlong),)     # 24 strides
            + (ctypes.c_int, ctypes.c_float, ctypes.c_float)  # window, scale, softcap
            + (ctypes.c_void_p,))                      # stream


def flash_attention_bwd(q, k, v, o, lse, do, *, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The gradient of ``flash_attention``: (dq, dk, dv) for q (B, S, H,
    hd), k, v (B, S, G, hd), the forward's output ``o``, its row
    log-sum-exp ``lse`` (B, H, S) (``flash_attention(..., return_lse=True)``)
    and the gradient ``do`` of the loss in o (o and do like q), each
    gradient in its input's dtype. Takes what the forward takes (dtype,
    head dim, GQA); on the card also what the TMA loads need, of q, k, v,
    o and do in either dtype (``tma_violation``; raises before any launch,
    no other path).

    CUDA tensors: one call of ``csrc/flash_attention_bwd.cu``'s C entry of
    the dtype, which launches its three ``BWD_KERNELS`` in order (float32
    scratch for each row's lse in base 2 and D = rowsum(do o), padded to
    whole FLASH_BWD_TC_BLOCK_ROWS blocks), counted in
    ``flash_attention_bwd.launches`` and under the dtype's name in
    ``flash_attention_bwd.kernel_launches``. CPU tensors:
    ``ref.flash_attention_bwd_ref``. Meta tensors: gradients of those
    shapes and dtypes, nothing launched.
    """
    _check_inputs(q, k, v, q_by_tma=True)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not match "
                             f"q {tuple(q.shape)} {q.dtype} on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim is not contiguous")
        why = (tma_violation(t.shape, t.stride(), t.dtype, t.data_ptr())
               if t.device.type == "cuda" else None)
        if why is not None:
            raise ValueError(f"{name}: the {t.dtype} kernel cannot read it: {why}")
    B, S, H, hd = q.shape
    want = (B, H, S)
    if (tuple(lse.shape) != want or lse.dtype != ref._acc_dtype(q.dtype)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} on {lse.device} is not a "
                         f"contiguous {ref._acc_dtype(q.dtype)} {want} on {q.device}")
    w = int(window) if window is not None and int(window) > 0 else 0
    if q.device.type == "meta":
        return _flash_bwd_meta(q, k, v, w)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=w or None,
                                           softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")
    G = k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    rows = autotune.FLASH_BWD_TC_BLOCK_ROWS
    stat_s = -(-S // rows) * rows
    lse2, dsum = torch.empty((2, B * H, stat_s), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(st for t in tensors
                                         for st in tma_strides(t.shape, t.stride())))
    entry, tiles = _BWD_ENTRIES[q.dtype]
    fn = _launch.c_entry("flash_attention_bwd.cu", entry, _bwd_argtypes(len(tiles)))
    _launch.call(fn, q.device, *(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv, lse2,
                                                        dsum)),
                 B, S, H, G, hd, *tiles, stat_s, strides, w, hd ** -0.5,
                 0.0 if softcap is None else float(softcap))
    name = _KERNEL_OF[q.dtype]
    flash_attention_bwd.launches += 1
    flash_attention_bwd.kernel_launches[name] += len(BWD_KERNELS[name])
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.kernel_launches = {"bf16": 0, "float32": 0}
