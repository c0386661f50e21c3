"""Causal GQA flash attention with a sliding window and a logit softcap.

Counterpart of ``repro.kernels.flash_attention``. ``flash_attention`` is
the wrapper of the CUDA kernel ``flash_attention_kernel``
(``csrc/flash_attention.cu``): on CUDA tensors it launches the kernel, on
CPU tensors it computes the plain version ``ref.flash_attention_ref``.
Either way it first checks what the kernel takes: float32 or bf16 q, k, v
of one type, q (B, S, H, hd) and k, v (B, S, G, hd) with G dividing H,
hd in ``autotune.FLASH_HEAD_DIMS``, the head dim contiguous. Other strides
are read as they are: nothing is transposed or copied.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _launch, autotune, ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    (ctypes.c_void_p,) * 4                      # q, k, v, o
    + (ctypes.c_int,) * 9                       # B, S, H, G, hd, is_bf16, tiles
    + (ctypes.POINTER(ctypes.c_longlong),)      # 12 strides
    + (ctypes.c_int, ctypes.c_float, ctypes.c_float)  # window, scale, softcap
    + (ctypes.c_void_p,)                        # stream
)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
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


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v (B, S, G, hd); query
    head h reads KV head h // (H // G). ``window`` None or <= 0 is global;
    ``softcap`` None is none. Returns (B, S, H, hd) in q's dtype.

    CUDA tensors: one launch of the kernel, counted in
    ``flash_attention.launches``. CPU tensors: ``ref.flash_attention_ref``.
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
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    fn = _launch.c_entry("flash_attention.cu", "repro_flash_attention", _ARGTYPES)
    _launch.call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, H, G, hd, int(q.dtype == torch.bfloat16),
                 autotune.FLASH_BLOCK_Q, autotune.FLASH_BLOCK_K,
                 autotune.FLASH_THREADS_PER_ROW, strides, w, hd ** -0.5,
                 0.0 if softcap is None else float(softcap))
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
