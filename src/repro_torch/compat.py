"""Runtime sanitizers (counterpart of the sanitizer half of ``repro.compat``).

The reference's other half shims jax APIs across versions; the port has
no such shims.

- ``sync_guard`` is the counterpart of ``transfer_guard("disallow")``:
  under ``torch.cuda.set_sync_debug_mode("error")`` an operation that
  makes the host wait for the card (``.item()``, ``float()`` or ``bool()``
  of a CUDA tensor, ``.cpu()``, ``nonzero``, a copy from pageable host
  memory) raises, so a path run under it is proved to stay on the card
  between its named boundaries.
- ``checking_leaks`` has no counterpart: it catches a jax tracer escaping
  its trace, and eager torch has no tracers.
- ``CompilationCounter`` and ``backend_compile_count`` count the port's
  compiles, the nvcc runs of ``kernels.build.build`` (one a source): the
  reference counts XLA's backend compiles, which pin "compiled once per
  shape"; here they pin "built once per checkout".
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import nvcc_path
from repro_torch.kernels import build


@contextlib.contextmanager
def _sync_debug_mode(mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def sync_guard(mode: str = "error"):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the ``with`` block, the
    previous mode restored on exit ("error": a synchronizing CUDA
    operation raises; "warn": it warns). A null context where CUDA is
    not available, as the reference's guard is on an old jax."""
    if not torch.cuda.is_available():
        return contextlib.nullcontext()
    return _sync_debug_mode(mode)


def backend_compile_count() -> int:
    """nvcc runs this process has started (``kernels.build.build``)."""
    return build.compiles


class CompilationCounter:
    """Counts the kernel compiles inside a ``with`` block.

    >>> with CompilationCounter() as c:
    ...     build.build()   # warm: every library already built
    >>> c.count             # 0; one a source compiled otherwise

    ``supported`` is False where there is no nvcc (nothing can compile);
    callers gating on ``count`` should skip (not pass) then.
    """

    count: int = 0
    supported: bool = False

    def __enter__(self) -> "CompilationCounter":
        self.supported = nvcc_path() is not None
        self._start = build.compiles
        self.count = 0
        return self

    def __exit__(self, *exc) -> bool:
        self.count = build.compiles - self._start
        return False
