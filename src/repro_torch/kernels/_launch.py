"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import autotune, build


def check_operands(names, tensors, shapes, dtype=torch.float32) -> None:
    """Every operand a contiguous ``dtype`` tensor on one CUDA device with
    its expected shape; raises on anything else."""
    dev = tensors[0].device
    for name, t, want in zip(names, tensors, shapes):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the other operands on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtype} here")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_row_block(row_block: int, L: int, method: str) -> int:
    """``row_block`` if a block of that many rows of width ``L`` launches
    with ``method`` (``autotune.legal_row_block``); raises otherwise."""
    if not autotune.legal_row_block(row_block, L, method):
        raise ValueError(
            f"row_block={row_block} does not launch at L={L} with {method}: rows "
            f"per block must be a power of two in {autotune.ROW_BLOCKS} and a block "
            f"of them at most {autotune.SORTSCAN_MAX_THREADS} threads"
        )
    return row_block


def check_iters(iters: int) -> int:
    """A bisection iteration count the kernels take; raises otherwise."""
    if not 0 <= iters <= autotune.MAX_BISECT_ITERS:
        raise ValueError(f"iters={iters} outside 0..{autotune.MAX_BISECT_ITERS}")
    return iters


@functools.cache
def c_entry(source: str, symbol: str, argtypes: tuple):
    """The C entry ``symbol`` of the library built from ``source``, with
    its ctypes ``argtypes`` declared (each argument its own type: a float
    passed as c_int arrives as garbage, a pointer as c_int is cut to 32
    bits) and an int return, the CUDA error of the launch."""
    fn = getattr(build.library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _entry(source: str, symbol: str, n_ptrs: int, n_ints: int):
    """A row-kernel entry: n_ptrs pointers, then n_ints ints, then the
    stream."""
    return c_entry(source, symbol, (ctypes.c_void_p,) * n_ptrs
                   + (ctypes.c_int,) * n_ints + (ctypes.c_void_p,))


def call(fn, device: torch.device, *args) -> None:
    """Call the C entry ``fn`` with ``args`` and PyTorch's current stream of
    ``device`` last; raises if CUDA refused the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {fn.__name__} failed with error {rc}")


def launch(source: str, symbol: str, operands, out: torch.Tensor, L: int,
           row_block: int, *extra: int, method: str) -> None:
    """Launch ``symbol`` over the rows of ``out``, ``row_block`` rows per
    block in ``method``'s layout, on PyTorch's current stream; the C entry
    takes (n, L, threads of a row, row_block, *extra). Raises if CUDA
    refuses the launch."""
    ints = (out.shape[0], L, autotune.row_threads(L, method), row_block, *extra)
    fn = _entry(source, symbol, len(operands) + 1, len(ints))
    call(fn, out.device, *(t.data_ptr() for t in operands), out.data_ptr(), *ints)
