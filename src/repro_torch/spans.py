"""Spans at the program's layer boundaries, recorded only while a torch
profiler records.

The port's own instrumentation; the JAX package has no counterpart.
``span(name)`` is a context manager. With no profiler recording it returns
one shared no-op context after a single flag check, and allocates nothing.
While a profiler records (``torch.profiler.profile``, or any profiler that
sets ``torch.autograd.profiler``'s enabled flag), it opens a
``torch.profiler.record_function`` range of that name, so the span lands
in the profiler's trace beside the operators and kernels it encloses, on
the same clock, and adds its host time to in-memory aggregates by name:
how often it ran, its total time, and its self time (the total less the
time of the spans opened inside it on the same thread; each thread keeps
its own stack, since a sweep's prefetch thread runs program code too).
A span launches, synchronises and allocates nothing on the device.

There are no span logs and no exporter: the profiler's Chrome trace is the
export. ``snapshot`` reads the aggregates and ``reset`` clears them. Every
name starts with ``repro_torch.``.
"""
from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
# name -> [count, total_ns, self_ns]
_totals: dict[str, list[int]] = {}


class _Open(threading.local):
    """The spans open on this thread, innermost last."""

    def __init__(self):
        self.stack = []


_open = _Open()


class _Span:
    __slots__ = ("name", "range", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name
        self.range = _profiler.record_function(name)
        self.child_ns = 0

    def __enter__(self):
        self.range.__enter__()
        _open.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        with _lock:
            agg = _totals.setdefault(self.name, [0, 0, 0])
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
        self.range.__exit__(*exc)


def span(name: str):
    """A context that records ``name`` while a torch profiler records, and
    the shared no-op context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def snapshot() -> dict[str, tuple[int, int, int]]:
    """{name: (count, total_ns, self_ns)} of every span recorded since the
    last ``reset``."""
    with _lock:
        return {name: tuple(agg) for name, agg in _totals.items()}


def reset() -> None:
    """Clear the aggregates."""
    with _lock:
        _totals.clear()
