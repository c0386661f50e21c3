"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import autotune, build


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


def check_row_block(row_block: int, L: int) -> int:
    """``row_block`` if a block of that many rows of width ``L`` launches
    (``autotune.legal_row_block``); raises otherwise."""
    if not autotune.legal_row_block(row_block, L):
        raise ValueError(
            f"row_block={row_block} does not launch at L={L}: rows per block "
            f"must be a power of two with row_block * {autotune.slots_for(L)} "
            f"<= {autotune.MAX_THREADS} threads and its shared memory within "
            f"{autotune.SMEM_BUDGET} bytes"
        )
    return row_block


def check_iters(iters: int) -> int:
    """A bisection iteration count the kernels take; raises otherwise."""
    if not 0 <= iters <= autotune.MAX_BISECT_ITERS:
        raise ValueError(f"iters={iters} outside 0..{autotune.MAX_BISECT_ITERS}")
    return iters


@functools.cache
def _entry(source: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry ``symbol`` of the library built from ``source``: n_ptrs
    pointers, then n_ints ints, then the stream, pointers as c_void_p."""
    fn = getattr(build.library(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(source: str, symbol: str, operands, out: torch.Tensor, L: int,
           row_block: int, *extra: int) -> None:
    """Launch ``symbol`` over the rows of ``out``, ``row_block`` rows per
    block, on PyTorch's current stream; the C entry takes (n, L, threads,
    row_block, *extra). Raises if CUDA refuses the launch."""
    ints = (out.shape[0], L, autotune.slots_for(L), row_block, *extra)
    fn = _entry(source, symbol, len(operands) + 1, len(ints))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in operands), out.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {symbol} failed with error {rc}")
