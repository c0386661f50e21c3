"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import autotune, build

_SOURCE = "oga_step.cu"


def check_operands(names, tensors, shapes) -> None:
    """Every operand a contiguous float32 tensor on one CUDA device with its
    expected shape; raises on anything else."""
    dev = tensors[0].device
    for name, t, want in zip(names, tensors, shapes):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the other operands on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


@functools.cache
def _entry(symbol: str, n_ptrs: int):
    """The C entry ``symbol``: n_ptrs pointers, then n, L, threads as ints,
    then the stream, every pointer declared c_void_p."""
    fn = getattr(build.library(_SOURCE), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(symbol: str, operands, out: torch.Tensor, L: int) -> None:
    """Launch ``symbol`` of the kernel library over the rows of ``out`` on
    PyTorch's current stream; raises if CUDA refuses the launch."""
    fn = _entry(symbol, len(operands) + 1)
    threads = autotune.slots_for(L)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in operands), out.data_ptr(),
                out.shape[0], L, threads, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {symbol} failed with error {rc}")
