"""Causal GQA flash attention with a sliding window and a logit softcap.

Counterpart of ``repro.kernels.flash_attention``. ``flash_attention`` is
the wrapper of two CUDA kernels in ``csrc/flash_attention.cu``: bf16
tensors launch the tensor-core kernel ``flash_attention_wgmma_kernel``,
float32 tensors the scalar kernel ``flash_attention_kernel``; CPU tensors
compute the plain version ``ref.flash_attention_ref``. Either way it
first checks what the kernels take: float32 or bf16 q, k, v of one type,
q (B, S, H, hd) and k, v (B, S, G, hd) with G dividing H, hd in
``autotune.FLASH_HEAD_DIMS``, the head dim contiguous, and for bf16 on
the card what the tensor-core kernel's loads need (``tma_violation``).
Other strides are read as they are: nothing is transposed or copied.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _launch, autotune, ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    (ctypes.c_void_p,) * 4                      # q, k, v, o
    + (ctypes.c_int,) * 8                       # B, S, H, G, hd, three tile constants
    + (ctypes.POINTER(ctypes.c_longlong),)      # 12 strides
    + (ctypes.c_int, ctypes.c_float, ctypes.c_float)  # window, scale, softcap
    + (ctypes.c_void_p,)                        # stream
)
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


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    G = k.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"{G} KV heads do not divide {H} query heads")
    if hd not in autotune.FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {autotune.FLASH_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {_DTYPES}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim is not contiguous")
        if t.dtype == torch.bfloat16 and t.device.type == "cuda":
            why = tma_violation(t.shape, t.stride(), t.dtype, t.data_ptr())
            if why is not None:
                raise ValueError(f"{name}: the bf16 kernel cannot read it: {why}")


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v (B, S, G, hd); query
    head h reads KV head h // (H // G). ``window`` None or <= 0 is global;
    ``softcap`` None is none. Returns (B, S, H, hd) in q's dtype.

    CUDA tensors: one launch of the bf16 or the float32 kernel, counted in
    ``flash_attention.launches`` and in ``flash_attention.kernel_launches``
    under the dtype's name. CPU tensors: ``ref.flash_attention_ref``.
    """
    _check_inputs(q, k, v)
    w = int(window) if window is not None and int(window) > 0 else 0
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=w or None, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    B, S, H, hd = q.shape
    G = k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.dtype == torch.bfloat16:
        dims = [tma_strides(t.shape, t.stride()) for t in (q, k, v, o)]
        entry, tiles = "repro_flash_attention_bf16", (
            autotune.FLASH_TC_BLOCK_Q, autotune.FLASH_TC_BLOCK_K, autotune.FLASH_TC_STAGES)
    else:
        dims = [tuple(t.stride(i) for i in range(3)) for t in (q, k, v, o)]
        entry, tiles = "repro_flash_attention", (
            autotune.FLASH_BLOCK_Q, autotune.FLASH_BLOCK_K, autotune.FLASH_THREADS_PER_ROW)
    strides = (ctypes.c_longlong * 12)(*(st for d in dims for st in d))
    fn = _launch.c_entry("flash_attention.cu", entry, _ARGTYPES)
    _launch.call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, H, G, hd, *tiles, strides, w, hd ** -0.5,
                 0.0 if softcap is None else float(softcap))
    flash_attention.launches += 1
    flash_attention.kernel_launches[_KERNEL_OF[q.dtype]] += 1
    return o


_KERNEL_OF = {torch.bfloat16: "bf16", torch.float32: "float32"}
flash_attention.launches = 0
flash_attention.kernel_launches = {"bf16": 0, "float32": 0}
