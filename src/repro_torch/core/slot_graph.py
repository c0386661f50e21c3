"""OGASCHED's slot replayed as one CUDA graph.

The JAX package has no counterpart: its ``lax.scan`` compiles the whole
loop. Here ``ogasched.oga_step`` hands every slot to ``run``, which
captures the slot's kernels once per cluster and replays them, so the host
issues one graph launch a slot in place of each operator. It decides from
what the call shows, with no setting of its own:

- ``key`` is what a captured slot depends on: the device, L, R and K, the
  dtype, ``decay``, the storage of every spec field and operand, and the
  layout of y(t), x(t) and eta. It is None on the "reference" backend,
  without operands, with a tensor that requires grad, on mixed devices,
  with an input that is not a permutation of a contiguous tensor, or with
  a ``decay`` that is neither a number nor a tensor on the slot's device;
  the slot then runs eagerly, as it does off CUDA.
- ``action``: a device's graph replays every call with its key; a key that
  repeats on consecutive calls is captured on the second, which frees the
  device's former graph and its memory pool; every other call runs
  eagerly. So a caller that keeps one cluster captures once (its first
  call, with the zero start's layout, and its second run eagerly), and one
  that alternates clusters never captures.

A replay copies y(t), x(t) and eta into the graph's static inputs, replays
the reward, the k*, x and eta rows, the fused kernel and the unpack, and
returns copies of y(t+1), q_t and eta * decay: the same kernels on the
same operands in the same order as the eager slot, so the values are the
eager ones bit for bit, and no later replay overwrites what a call
returned. The graph holds what it reads (the spec's fields, the operands,
a tensor ``decay``) weakly and goes when the first of them is freed: no
replay reads storage that was reused, and a cluster's graph and its
memory pool do not outlive the cluster. ``oga_step_fused.launches`` and
``launches_by_shape`` count the captured launches once a replay; ``counts``
says how often each path ran, and a replay runs inside the span
``repro_torch.oga_step.replay``.
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch

from repro_torch import spans
from repro_torch.core.graph import ClusterSpec
from repro_torch.kernels import oga_step as _og
from repro_torch.kernels import ops

REPLAY_SPAN = "repro_torch.oga_step.replay"

# how often a slot ran eagerly, was captured and was replayed
counts = collections.Counter()
# device -> its captured slot (at most one), and the key of its last call
_graphs: dict = {}
_last: dict = {}


@functools.lru_cache(maxsize=64)
def _dense(shape, stride) -> bool:
    """Whether a tensor of ``shape`` and ``stride`` fills its span of memory
    once: a permutation of a contiguous tensor."""
    span = 1
    for st, size in sorted((st, n) for st, n in zip(stride, shape) if n != 1):
        if st != span:
            return False
        span *= size
    return True


def _read(spec: ClusterSpec, decay, operands) -> tuple:
    """The tensors a captured slot reads in place: the spec's fields, the
    operands and a tensor ``decay``."""
    held = (spec.mask, spec.a, spec.c, spec.alpha, spec.beta, spec.kinds, *operands)
    return held + (decay,) if isinstance(decay, torch.Tensor) else held


def key(spec: ClusterSpec, y, x, eta, decay, backend: str, operands):
    """What a captured slot of these arguments depends on, or None where no
    graph may run it (module docstring). The shapes and dtypes in it carry
    L, R, K and the dtype; the backend is "fused" wherever the key is not
    None, so the key leaves it out."""
    if operands is None or ops.resolve_oga_backend(backend) != "fused":
        return None
    inputs = (y, x, eta)
    if not all(isinstance(t, torch.Tensor) for t in inputs):
        return None
    held = _read(spec, decay, operands)
    if isinstance(decay, torch.Tensor):
        decay_key = None
    elif isinstance(decay, (int, float)):
        decay_key = (type(decay), decay)
    else:
        return None
    dev = y.device
    for t in held + inputs:
        if t.requires_grad or t.device != dev:
            return None
    layouts = tuple((t.dtype, t.shape, t.stride()) for t in inputs)
    if not all(_dense(shape, stride) for _, shape, stride in layouts):
        return None
    return (dev, decay_key, tuple((t.data_ptr(), t.dtype, t.shape, t.stride()) for t in held),
            layouts)


def action(captured, last, k) -> str:
    """"replay" where ``k`` is the key of the device's graph (``captured``),
    "capture" where it is the key of the device's last call (``last``),
    else "eager"; a None key runs eagerly."""
    if k is None:
        return "eager"
    if k == captured:
        return "replay"
    return "capture" if k == last else "eager"


class SlotGraph:
    """One captured slot: the graph, its static inputs and outputs, and the
    fused kernel's launches it holds."""

    def __init__(self, k, slot, spec, y, x, eta, decay, backend, operands):
        self.key = k
        y_in, x_in, eta_in = (
            torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
            for t in (y, x, eta))
        fused = _og.oga_step_fused
        launches, by_shape = fused.launches, collections.Counter(fused.launches_by_shape)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(y.device),
                              capture_error_mode="thread_local"):
            out = slot(spec, y_in, x_in, eta_in, decay, backend, operands)
        self.graph, self.inputs, self.out = graph, (y_in, x_in, eta_in), out
        # the capture ran no kernel: its launches are counted at each replay
        self.launches = fused.launches - launches
        self.by_shape = fused.launches_by_shape - by_shape
        fused.launches = launches
        fused.launches_by_shape.clear()
        fused.launches_by_shape.update(by_shape)

    def replay(self, y, x, eta):
        """(y(t+1), q_t, eta * decay) of the slot at y(t), x(t) and eta,
        each a fresh copy."""
        with spans.span(REPLAY_SPAN):
            for static, t in zip(self.inputs, (y, x, eta)):
                static.copy_(t)
            self.graph.replay()
            fused = _og.oga_step_fused
            fused.launches += self.launches
            fused.launches_by_shape.update(self.by_shape)
            return tuple(t.clone() for t in self.out)


def run(slot, spec, y, x, eta, decay, backend, operands):
    """``slot(spec, y, x, eta, decay, backend, operands)``, which returns
    (y(t+1), q_t, eta * decay): replayed from the device's graph, captured
    first, or called, as ``action`` decides."""
    k = key(spec, y, x, eta, decay, backend, operands)
    if k is None or k[0].type != "cuda":
        counts["eager"] += 1
        return slot(spec, y, x, eta, decay, backend, operands)
    dev = k[0]
    what = action(_graphs[dev].key if dev in _graphs else None, _last.get(dev), k)
    _last[dev] = k
    if what == "eager":
        counts["eager"] += 1
        return slot(spec, y, x, eta, decay, backend, operands)
    if what == "capture":
        # the former graph and its memory pool go before the new capture
        _graphs.pop(dev, None)
        _graphs[dev] = SlotGraph(k, slot, spec, y, x, eta, decay, backend, operands)
        _free_with(_graphs[dev], dev, _read(spec, decay, operands))
        counts["captures"] += 1
    counts["replays"] += 1
    return _graphs[dev].replay(y, x, eta)


def _free_with(graph, dev, tensors) -> None:
    """Hold ``tensors`` weakly on ``graph``: the first of them to be freed
    frees the device's graph, so no replay reads storage that was reused,
    and a cluster's graph and its memory pool go with the cluster."""
    me = weakref.ref(graph)

    def forget(_):
        if _graphs.get(dev) is me():
            _graphs.pop(dev, None)

    graph.reads = [weakref.ref(t, forget) for t in tensors]


def reset() -> None:
    """Free every device's graph and forget the last keys and the counts."""
    _graphs.clear()
    _last.clear()
    counts.clear()
