"""The sweep engine: resident grids, streamed and resumable grids, slot
mode and lifecycle mode, and the comparison path it shares with the
simulator.

Counterpart of ``repro.sched.sweep``. A grid of configurations becomes one
stacked batch; OGASCHED's fused backend runs the whole grid with ONE
kernel launch per step (the grid axis flattened into the kernel's rows,
``ogasched.run_batch``), the heuristics through ``baselines.run_batch``;
in lifecycle mode every algorithm runs ``lifecycle.run_batch``, the same
slot function over the G configurations.

  * ``make_grid``    — cartesian product of sweep axes -> list[SweepPoint].
  * ``build_batch``  — traces stacked on a leading grid axis: host numpy
                       (the bitwise-pinned path) or one batched generation
                       on the device (``trace_backend``, sched.trace_device),
                       with job sizes and fault streams where the mode
                       needs them.
  * ``run_algorithm``— single-config rewards; the path ``simulator.run_all``
                       calls per algorithm in slot mode.
  * ``run_grid``     — every algorithm over every configuration.
  * ``run_grid_sharded`` — the grid split over a list of devices; on one
                       card it is ``run_grid``.
  * ``iter_batches`` / ``run_grid_stream`` / ``sweep_stream`` — the chunked
                       loop: generate, run and reduce ``chunk_size``
                       configurations at a time, the next chunks prepared
                       on a background thread (``prefetch``), so a 10k-
                       config grid never holds (G, T, ...) tensors; grids of
                       ``DEVICE_TRACE_MIN_POINTS`` or more synthesize their
                       traces on the device by default.
  * ``SweepCheckpoint`` / ``sweep_fingerprint`` — resume after a crash:
                       each finished chunk's summaries are committed through
                       ``ckpt.CheckpointManager`` under a manifest bound to
                       the sweep's fingerprint (the reference's digest for
                       the same grid), and a rerun skips the finished chunks.
  * ``summarize`` / ``summarize_lifecycle`` — per-config metrics.

All points share (L, R, K, T). The reference's buffer donation has no
counterpart in eager PyTorch: a donating stream drops its chunk's input
references on the card instead.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import queue as queue_mod
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_io
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import baselines, ogasched
from repro_torch.core.graph import ClusterSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.sched import lifecycle, trace

ALGORITHMS = ("ogasched",) + baselines.BASELINES

MODES = ("slot", "lifecycle")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'slot' or 'lifecycle', got {mode!r}")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One grid configuration: a trace plus OGA hyperparameters."""

    cfg: trace.TraceConfig
    eta0: float = 25.0
    decay: float = 0.9999


@dataclasses.dataclass
class SweepBatch:
    """Stacked operands for a grid of G configurations: every spec field
    and ``arrivals`` lead with (G,); ``works`` (job sizes, lifecycle mode
    and size-aware slot grids) and ``faults`` (capacity multipliers, when
    some point's fault process is active) are None otherwise; ``points``
    keeps each row's provenance in the same order."""

    spec: ClusterSpec                      # every field (G, ...)
    arrivals: torch.Tensor                 # (G, T, L)
    eta0: torch.Tensor                     # (G,)
    decay: torch.Tensor                    # (G,)
    works: Optional[torch.Tensor] = None   # (G, T, L)
    faults: Optional[torch.Tensor] = None  # (G, T, K)
    points: tuple[SweepPoint, ...] = ()

    @property
    def size(self) -> int:
        return self.arrivals.shape[0]


def make_grid(
    base: Optional[trace.TraceConfig] = None,
    *,
    eta0s: Sequence[float] = (25.0,),
    decays: Sequence[float] = (0.9999,),
    utilities: Sequence[str] = ("mixed",),
    seeds: Optional[Sequence[int]] = None,
    rhos: Optional[Sequence[float]] = None,
    contentions: Optional[Sequence[float]] = None,
) -> list[SweepPoint]:
    """Cartesian product of sweep axes over a base TraceConfig.

    Axis order (slowest to fastest): eta0, decay, utility, seed, rho,
    contention, as in the reference.
    """
    base = trace.TraceConfig() if base is None else base
    seeds = (base.seed,) if seeds is None else seeds
    rhos = (base.rho,) if rhos is None else rhos
    contentions = (base.contention,) if contentions is None else contentions
    points = []
    for eta0, decay, util, seed, rho, cont in itertools.product(
        eta0s, decays, utilities, seeds, rhos, contentions
    ):
        cfg = dataclasses.replace(base, utility=util, seed=seed, rho=rho, contention=cont)
        points.append(SweepPoint(cfg=cfg, eta0=eta0, decay=decay))
    return points


# "auto" trace backend: grids of at least this many points stream traces
# synthesized on the device (sched.trace_device); smaller grids keep the
# bitwise-pinned host path, so resident/streamed comparisons stay exact
DEVICE_TRACE_MIN_POINTS = 1024

TRACE_BACKENDS = ("auto",) + trace.TRACE_BACKENDS


def resolve_trace_backend(trace_backend: str, n_points: int) -> str:
    """"auto" -> "device" for grids of DEVICE_TRACE_MIN_POINTS points or
    more (where host numpy generation would dominate the stream), "host"
    otherwise."""
    if trace_backend not in TRACE_BACKENDS:
        raise ValueError(
            f"trace_backend must be one of {TRACE_BACKENDS}, got {trace_backend!r}"
        )
    if trace_backend == "auto":
        return "device" if n_points >= DEVICE_TRACE_MIN_POINTS else "host"
    return trace_backend


def needs_works(algorithms: Sequence[str], mode: str) -> bool:
    """Whether a run must carry job sizes: always in lifecycle mode, and in
    slot mode exactly when a size-aware baseline is in the pool."""
    return mode == "lifecycle" or any(a in baselines.SIZE_AWARE for a in algorithms)


def needs_faults(points: Sequence[SweepPoint], mode: str) -> bool:
    """Whether a grid must carry a fault stream: some point's fault process
    is active. Faults act in lifecycle mode only; an active fault config in
    slot mode raises instead of being ignored."""
    active = any(p.cfg.faults.active for p in points)
    if active and mode != "lifecycle":
        raise ValueError(
            "fault injection (cfg.faults) requires mode='lifecycle': slot "
            "mode holds nothing across slots, so capacity faults would be "
            "silently ignored"
        )
    return active


def build_batch(
    points: Sequence[SweepPoint],
    mode: str = "slot",
    *,
    trace_backend: str = "host",
    with_works: Optional[bool] = None,
    device: DeviceLike = None,
) -> SweepBatch:
    """Generate every point's trace and stack it on ``device`` (None: the
    CUDA card). Lifecycle mode also samples job sizes (slot mode when
    ``with_works``, for size-aware baselines), and fault streams exactly
    when a point's ``cfg.faults`` is active (``needs_faults``).
    ``trace_backend`` selects host numpy (the bitwise-pinned path, the
    default) or one batched generation on the device
    (``trace.make_batch(trace_backend="device")``); "auto" resolves by the
    number of points (``resolve_trace_backend``)."""
    _check_mode(mode)
    if not points:
        raise ValueError("empty sweep grid")
    if with_works is None:
        with_works = mode == "lifecycle"
    spec, arrivals, works, faults = trace.make_batch(
        [p.cfg for p in points], with_works=with_works,
        trace_backend=resolve_trace_backend(trace_backend, len(points)),
        with_faults=needs_faults(points, mode), device=device)
    dev = arrivals.device
    return SweepBatch(
        spec=spec,
        arrivals=arrivals,
        eta0=torch.tensor([p.eta0 for p in points], dtype=torch.float32, device=dev),
        decay=torch.tensor([p.decay for p in points], dtype=torch.float32, device=dev),
        works=works,
        faults=faults,
        points=tuple(points),
    )


def run_algorithm(spec: ClusterSpec, arrivals, name: str, *, eta0=25.0,
                  decay=0.9999, backend: str = "auto",
                  works: Optional[torch.Tensor] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """(T,) per-slot rewards of one algorithm on one configuration;
    size-aware baselines (``baselines.SIZE_AWARE``) consume ``works`` (T, L)
    job sizes."""
    if name == "ogasched":
        rewards, _ = ogasched.run(spec, arrivals, eta0=eta0, decay=decay,
                                  backend=backend, device=device)
        return rewards
    return baselines.run(spec, arrivals, name, device=device, works=works)


def run_grid(
    batch: SweepBatch,
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    backend: str = "auto",
    mode: str = "slot",
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    tiling=None,
) -> dict:
    """Every algorithm over every configuration of ``batch``, on the
    batch's device, in ``algorithms`` order.

    mode="slot": {name: (G, T) rewards}. ``backend`` applies to OGASCHED
    only. "fused" ("auto") flattens the grid into the fused kernel's rows:
    one launch per step for the whole grid (``ogasched.run_batch``), with
    ``tiling`` pinning its row block (default: the autotune cache).
    "reference" runs the spec-level update config by config, for A/B.

    mode="lifecycle": {name: LifecycleTrace} with fields leading (G, T),
    from ``lifecycle.run_batch`` (jobs hold resources until their work
    drains; ``batch.faults`` runs every row against its surviving
    capacity with ``fault_policy``); reduce with ``summarize_lifecycle``.
    """
    _check_mode(mode)
    if batch.works is None and needs_works(algorithms, mode):
        raise ValueError(
            "grid needs job sizes: build_batch(points, mode='lifecycle') "
            "or build_batch(points, with_works=True) for size-aware "
            "slot-mode baselines"
        )
    dev = batch.arrivals.device
    out: dict = {}
    for name in algorithms:
        if mode == "lifecycle":
            out[name] = lifecycle.run_batch(
                batch.spec, batch.arrivals, batch.works, name, eta0=batch.eta0,
                decay=batch.decay, queue_depth=queue_depth, rate_floor=rate_floor,
                backend=backend if name == "ogasched" else "reference",
                faults=batch.faults, fault_policy=fault_policy, device=dev)
        elif name != "ogasched":
            out[name] = baselines.run_batch(
                batch.spec, batch.arrivals, name, device=dev,
                works=batch.works if name in baselines.SIZE_AWARE else None)
        elif ops.resolve_oga_backend(backend) == "fused":
            out[name], _ = ogasched.run_batch(batch.spec, batch.arrivals, batch.eta0,
                                              batch.decay, device=dev, tiling=tiling)
        else:
            out[name] = torch.stack([
                run_algorithm(batch.spec[g], batch.arrivals[g], name,
                              eta0=batch.eta0[g], decay=batch.decay[g],
                              backend=backend, device=dev)
                for g in range(batch.size)
            ])
    return out


# --------------------------------------------------------------------------
# Sharded grids: the G axis split in equal blocks over a list of devices.
# Rows are independent, so the result equals run_grid's; on one card
# run_grid_sharded is run_grid.
# --------------------------------------------------------------------------

def _pad_rows(x, pad: int):
    """Repeat the last grid row ``pad`` times (a tensor or every field of a
    stacked spec; None stays None)."""
    if pad == 0 or x is None:
        return x
    if isinstance(x, ClusterSpec):
        return ClusterSpec(*(_pad_rows(getattr(x, f), pad) for f in x.FIELDS))
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def _pad_batch(batch: SweepBatch, pad: int) -> SweepBatch:
    """``batch`` with its last row repeated ``pad`` times on every operand
    (``points`` keeps only the real points)."""
    if pad == 0:
        return batch
    return SweepBatch(
        spec=_pad_rows(batch.spec, pad), arrivals=_pad_rows(batch.arrivals, pad),
        eta0=_pad_rows(batch.eta0, pad), decay=_pad_rows(batch.decay, pad),
        works=_pad_rows(batch.works, pad), faults=_pad_rows(batch.faults, pad),
        points=batch.points,
    )


def _batch_rows(batch: SweepBatch, sl: slice, device=None, donated: bool = False) -> SweepBatch:
    """Grid rows ``sl`` of a batch, optionally moved to ``device``;
    ``donated`` drops the arrivals and job sizes."""
    take = lambda t: None if t is None else (t[sl] if device is None else t[sl].to(device))
    spec = batch.spec[sl] if device is None else batch.spec[sl].to(device)
    return SweepBatch(
        spec=spec,
        arrivals=None if donated else take(batch.arrivals),
        eta0=take(batch.eta0),
        decay=take(batch.decay),
        works=None if donated else take(batch.works),
        faults=take(batch.faults),
        points=batch.points,
    )


def run_grid_sharded(
    batch: SweepBatch,
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    mesh: Optional[Sequence[DeviceLike]] = None,
    backend: str = "auto",
    mode: str = "slot",
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    tiling=None,
) -> dict:
    """``run_grid`` with the grid axis split over ``mesh``, a sequence of
    devices (default: the batch's device alone).

    With one device this is ``run_grid``, so callers can use it
    unconditionally. Otherwise a grid that does not divide the device
    count is padded by repeating its last row, each device runs
    ``run_grid`` on its block, and the blocks are gathered on the batch's
    device with the padding sliced off: the rows equal ``run_grid``'s.
    """
    _check_mode(mode)
    kw = dict(backend=backend, mode=mode, queue_depth=queue_depth, rate_floor=rate_floor,
              fault_policy=fault_policy, tiling=tiling)
    if mesh is None or len(mesh) <= 1:
        return run_grid(batch, algorithms, **kw)
    if batch.works is None and needs_works(algorithms, mode):
        raise ValueError(
            "grid needs job sizes: build_batch(points, mode='lifecycle') "
            "or build_batch(points, with_works=True) for size-aware "
            "slot-mode baselines"
        )
    G, n = batch.size, len(mesh)
    pad = (-G) % n
    padded = _pad_batch(batch, pad)
    block = (G + pad) // n
    home = batch.arrivals.device
    parts = [run_grid(_batch_rows(padded, slice(i * block, (i + 1) * block),
                                  torch.device(d)), algorithms, **kw)
             for i, d in enumerate(mesh)]
    out = {}
    for name in algorithms:
        blocks = [p[name] for p in parts]
        if mode == "lifecycle":
            whole = lifecycle.LifecycleTrace(*(
                torch.cat([getattr(b, f).to(home) for b in blocks])
                for f in lifecycle.LifecycleTrace.FIELDS))
        else:
            whole = torch.cat([b.to(home) for b in blocks])
        out[name] = whole[:G]
    return out


# --------------------------------------------------------------------------
# Resumable sweeps: per-chunk summary checkpoints under a fingerprinted
# manifest. The chunk is the unit of progress: each finished chunk's
# reduced outputs are committed through the ckpt layer, so a SIGKILLed
# sweep restarts from its first incomplete chunk instead of from zero.
# --------------------------------------------------------------------------

class SweepResumeMismatch(ValueError):
    """A checkpoint directory belongs to a *different* sweep: its manifest
    fingerprint does not match the (grid, chunking, trace backend, run
    parameters) being resumed. Resuming would splice summaries of other
    configurations, so it is refused."""


def sweep_fingerprint(
    points: Sequence[SweepPoint],
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    chunk_size: int,
    mode: str = "slot",
    trace_backend: str = "auto",
    backend: str = "auto",
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
) -> str:
    """SHA-256 over everything that determines a streamed sweep's
    summaries: the reference's digest for the same grid and parameters.

    Covers every point's full TraceConfig and hyperparameters in order
    (``cfg.faults`` included), the algorithms, the chunking, the mode, the
    RESOLVED trace backend ("auto" fingerprints as what it resolves to),
    and the run parameters that reach the kernels, ``fault_policy``
    included. Execution layout (``prefetch``, ``donate``, ``tiling``,
    the device) is left out: it changes no summary bit, so a
    sweep checkpointed on one host may resume on another.
    """
    h = hashlib.sha256()
    header = {
        "algorithms": list(algorithms),
        "chunk_size": int(chunk_size),
        "mode": mode,
        "trace_backend": resolve_trace_backend(trace_backend, len(points)),
        "backend": backend,
        "queue_depth": int(queue_depth),
        "rate_floor": float(rate_floor),
        "fault_policy": dataclasses.asdict(fault_policy),
        "n_points": len(points),
    }
    h.update(json.dumps(header, sort_keys=True).encode())
    for p in points:
        row = dataclasses.asdict(p.cfg)
        row["eta0"] = float(p.eta0)
        row["decay"] = float(p.decay)
        h.update(json.dumps(row, sort_keys=True, default=float).encode())
    return h.hexdigest()


class SweepCheckpoint:
    """Crash-safe store of a streamed sweep's per-chunk summaries.

    Layout: ``<dir>/sweep_manifest.json`` binds the directory to ONE sweep
    (its ``sweep_fingerprint`` and readable provenance), published
    atomically; chunk ``i``'s reduced summary is checkpoint step ``i`` of
    a ``CheckpointManager`` with ``keep=None`` (every chunk kept; its init
    sweeps ``.tmp.*`` orphans of a killed writer). A summary dict is
    stored as arrays sorted by metric name, with the names in the step's
    manifest (``metrics``), so restore needs no live tree. The layout is
    the reference's, so either package resumes the other's store.

    Progress is the **contiguous valid prefix** of chunk checkpoints: the
    stream commits chunks in order, so the first missing or torn step is
    where a killed sweep re-enters the stream. A torn final write costs
    one chunk, never the sweep.
    """

    MANIFEST = "sweep_manifest.json"

    def __init__(
        self,
        directory: str,
        points: Sequence[SweepPoint],
        algorithms: Sequence[str] = ALGORITHMS,
        *,
        chunk_size: int = 64,
        mode: str = "slot",
        trace_backend: str = "auto",
        backend: str = "auto",
        queue_depth: int = 8,
        rate_floor: float = 1e-3,
        fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    ):
        self.dir = directory
        self.chunk_size = int(chunk_size)
        self.num_chunks = -(-len(points) // self.chunk_size)
        self.fingerprint = sweep_fingerprint(
            points, algorithms, chunk_size=chunk_size, mode=mode,
            trace_backend=trace_backend, backend=backend,
            queue_depth=queue_depth, rate_floor=rate_floor, fault_policy=fault_policy,
        )
        self.manager = CheckpointManager(directory, keep=None, every=1)
        man_path = os.path.join(directory, self.MANIFEST)
        if os.path.exists(man_path):
            with open(man_path) as f:
                have = json.load(f)
            if have.get("fingerprint") != self.fingerprint:
                raise SweepResumeMismatch(
                    f"checkpoint directory {directory!r} belongs to a "
                    "different sweep (grid/chunking/trace-backend/run-"
                    "parameter fingerprint mismatch); point it at a fresh "
                    "directory or rebuild the same grid"
                )
        else:
            ckpt_io.atomic_write_json(man_path, {
                "fingerprint": self.fingerprint,
                "n_points": len(points),
                "chunk_size": self.chunk_size,
                "num_chunks": self.num_chunks,
                "mode": mode,
                "algorithms": list(algorithms),
            })

    def completed_chunks(self) -> int:
        """Chunks durably finished: the length of the contiguous valid
        prefix."""
        n = 0
        while n < self.num_chunks and ckpt_io.verify_checkpoint(self.dir, n):
            n += 1
        return n

    def commit(self, chunk_index: int, summary: dict) -> None:
        """Durably record chunk ``chunk_index``'s reduced summary."""
        keys = sorted(summary)
        self.manager.save(chunk_index, [np.asarray(summary[k]) for k in keys],
                          extra={"metrics": keys})

    def load_summaries(self) -> list[dict[str, np.ndarray]]:
        """The finished chunks' summaries, in chunk order (the valid
        prefix)."""
        out = []
        for i in range(self.completed_chunks()):
            man = ckpt_io.read_manifest(self.dir, i)
            arrays = ckpt_io.load_checkpoint_arrays(self.dir, i)
            out.append(dict(zip(man["metrics"], arrays)))
        return out


# --------------------------------------------------------------------------
# Streaming grids: generate -> run -> reduce, one chunk at a time. A chunk
# is the only resident (g, T, ...) tensor set. The last partial chunk is
# padded to chunk_size, so every chunk launches the kernels at one shape
# (the one the autotune table holds), and trimmed before it is yielded.
# --------------------------------------------------------------------------

def _chunk_batches(
    points: Sequence[SweepPoint],
    chunk_size: int,
    mode: str,
    trace_backend: str,
    start_chunk: int = 0,
    with_works: Optional[bool] = None,
    device: DeviceLike = None,
) -> Iterator[tuple[slice, SweepBatch]]:
    """Synchronous chunk generation: the prefetch worker's body."""
    for start in range(start_chunk * chunk_size, len(points), chunk_size):
        chunk = list(points[start:start + chunk_size])
        batch = build_batch(chunk, mode=mode, trace_backend=trace_backend,
                            with_works=with_works, device=device)
        yield slice(start, start + len(chunk)), _pad_batch(batch, chunk_size - len(chunk))


class _PrefetchFailed:
    """Carries a worker-thread exception to the consumer, which re-raises it."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Drive ``it`` on a background thread through a bounded queue.

    The producer stays ``depth`` items ahead of the consumer (double
    buffering at the default depth 2), so chunk preparation (trace
    synthesis, padding, upload) overlaps the device work the consumer
    issues. Both threads issue to the device's default stream, so the
    device runs the work in the order it was issued. Order is kept,
    exceptions propagate, and abandoning the iterator (``close``,
    GeneratorExit) stops the worker.
    """
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(_DONE)
        except BaseException as exc:  # re-raised by the consumer
            _put(_PrefetchFailed(exc))

    t = threading.Thread(target=worker, name="sweep-chunk-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _PrefetchFailed):
                raise item.exc
            yield item
    finally:
        stop.set()
        # wait (bounded) for the worker to notice: a daemon thread killed
        # in the middle of a CUDA call at interpreter teardown can abort
        # the process. The worker re-checks ``stop`` every 0.1 s while the
        # queue is full, so the wait is the chunk generation in flight.
        t.join(timeout=30.0)


def iter_batches(
    points: Sequence[SweepPoint],
    chunk_size: int,
    *,
    mode: str = "slot",
    trace_backend: str = "host",
    prefetch: int = 2,
    start_chunk: int = 0,
    with_works: Optional[bool] = None,
    device: DeviceLike = None,
) -> Iterator[tuple[slice, SweepBatch]]:
    """Yield ``(grid_slice, batch)`` chunks of a point list, on ``device``
    (None: the CUDA card).

    Each batch carries exactly ``chunk_size`` rows: a final partial chunk
    is padded by repeating its last generated row (``_pad_rows``, no extra
    generation), while ``points`` keeps only the real points.
    ``grid_slice`` is the unpadded range of the grid the chunk covers, so
    ``batch.arrivals[: sl.stop - sl.start]`` are the real rows.

    ``prefetch`` > 0 generates chunks on a background thread through a
    bounded queue of that depth (default 2: double buffering);
    ``prefetch=0`` is synchronous. Chunk order and contents are the same
    either way. ``trace_backend`` is resolved against the FULL grid size,
    so "auto" picks the device path exactly when the grid is large.
    ``start_chunk`` skips that many leading chunks entirely (nothing is
    generated for them): a resumed sweep re-enters the stream there.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if start_chunk < 0:
        raise ValueError(f"start_chunk must be >= 0, got {start_chunk}")
    backend = resolve_trace_backend(trace_backend, len(points))
    it = _chunk_batches(points, chunk_size, mode, backend, start_chunk, with_works,
                        resolve_device(device))
    if prefetch > 0:
        it = _prefetched(it, prefetch)
    yield from it


def _donation_applies(algorithms: Sequence[str], mode: str) -> bool:
    """Whether a stream can drop its chunk's inputs early: in lifecycle
    mode always, in slot mode where the reference's OGASCHED dispatch
    donates."""
    if mode == "lifecycle":
        return len(algorithms) > 0
    return "ogasched" in algorithms


def run_grid_stream(
    points: Sequence[SweepPoint],
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    chunk_size: int = 64,
    mode: str = "slot",
    backend: str = "auto",
    trace_backend: str = "auto",
    prefetch: int = 2,
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    donate: bool = False,
    stats: Optional[dict] = None,
    checkpoint: Optional[SweepCheckpoint] = None,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    tiling=None,
    device: DeviceLike = None,
) -> Iterator[tuple[slice, SweepBatch, dict]]:
    """Stream a grid chunk by chunk on ``device`` (None: the CUDA card):
    yields ``(grid_slice, batch, outputs)``, both trimmed to the chunk's
    real rows. No (G, T, ...) tensor of the whole grid exists anywhere.

    Chunk generation runs ``prefetch`` chunks ahead on a background thread
    (``iter_batches``); ``trace_backend="auto"`` synthesizes the traces of
    grids of ``DEVICE_TRACE_MIN_POINTS`` points or more on the device and
    keeps the bitwise-pinned host path below that.

    ``donate=True`` stands for the reference's buffer donation: on the
    card the yielded batch carries ``arrivals=None`` / ``works=None`` and
    the stream holds no reference to the chunk's inputs once its outputs
    exist, so they are freed before the next chunk runs. Ignored on the
    CPU.

    ``stats`` (a dict) accumulates ``chunk_wait_s``: the time this thread
    waited on the prefetch pipeline (the trace synthesis, padding and
    upload the worker failed to hide). ``1 - chunk_wait_s / wall`` is the
    stream's overlap ratio.

    ``checkpoint`` (a ``SweepCheckpoint`` built for THIS grid and these
    run parameters; a fingerprint mismatch raises
    ``SweepResumeMismatch``) makes the stream resumable: chunks the store
    holds are skipped, never generated nor yielded. The stream does not
    commit: after consuming a chunk the caller calls
    ``checkpoint.commit(sl.start // chunk_size, reduced)``, as
    ``sweep_stream`` does with its summaries.
    """
    needs_faults(points, mode)  # slot-mode fault configs fail before chunk 0
    dev = resolve_device(device)
    start_chunk = 0
    if checkpoint is not None:
        fp = sweep_fingerprint(
            points, algorithms, chunk_size=chunk_size, mode=mode,
            trace_backend=trace_backend, backend=backend, queue_depth=queue_depth,
            rate_floor=rate_floor, fault_policy=fault_policy,
        )
        if fp != checkpoint.fingerprint:
            raise SweepResumeMismatch(
                "run_grid_stream arguments do not match the sweep this "
                "checkpoint store was built for"
            )
        start_chunk = checkpoint.completed_chunks()
    donate = donate and dev.type == "cuda" and _donation_applies(algorithms, mode)
    it = iter_batches(
        points, chunk_size, mode=mode, trace_backend=trace_backend, prefetch=prefetch,
        start_chunk=start_chunk, with_works=needs_works(algorithms, mode), device=dev,
    )
    while True:
        t_wait = time.monotonic()
        item = next(it, None)
        if stats is not None:
            stats["chunk_wait_s"] = stats.get("chunk_wait_s", 0.0) + time.monotonic() - t_wait
        if item is None:
            return
        sl, batch = item
        del item
        out = run_grid(batch, algorithms, backend=backend, mode=mode, queue_depth=queue_depth,
                     rate_floor=rate_floor, fault_policy=fault_policy, tiling=tiling)
        g = sl.stop - sl.start
        if g < batch.size:
            out = {n: v[:g] for n, v in out.items()}  # rewards or LifecycleTrace
        if g < batch.size or donate:
            batch = _batch_rows(batch, slice(0, g), donated=donate)
        yield sl, batch, out


def sweep_stream(
    points: Sequence[SweepPoint],
    algorithms: Sequence[str] = ALGORITHMS,
    *,
    chunk_size: int = 64,
    mode: str = "slot",
    backend: str = "auto",
    trace_backend: str = "auto",
    prefetch: int = 2,
    queue_depth: int = 8,
    rate_floor: float = 1e-3,
    checkpoint_dir: Optional[str] = None,
    fault_policy: lifecycle.FaultPolicy = lifecycle.FaultPolicy(),
    tiling=None,
    device: DeviceLike = None,
) -> dict[str, np.ndarray]:
    """Per-config summaries of a whole grid through the streaming loop,
    on ``device`` (None: the CUDA card).

    Returns what ``summarize`` (slot mode) / ``summarize_lifecycle``
    (lifecycle mode) return for a resident ``run_grid`` of the same points,
    {metric/name: (G,)}, with memory bounded by ``chunk_size``
    configurations: each chunk is reduced as it finishes (its inputs
    dropped on the card, ``run_grid_stream(donate=True)``), and only the
    (G,) summary rows accumulate.

    ``checkpoint_dir`` makes the sweep survive preemption: every finished
    chunk's summary is committed to a ``SweepCheckpoint`` store there, and
    a rerun with the same arguments loads the finished prefix from disk
    and computes only the remaining chunks. Pointing the store at another
    grid, chunking or run raises ``SweepResumeMismatch``. Resumed
    summaries are bit for bit those of an uninterrupted run: the store
    round-trips the arrays exactly, and no chunk's result depends on the
    chunks that ran before it in the process.
    """
    ckpt = None
    parts: dict[str, list[np.ndarray]] = {}
    if checkpoint_dir is not None:
        ckpt = SweepCheckpoint(
            checkpoint_dir, points, algorithms, chunk_size=chunk_size, mode=mode,
            trace_backend=trace_backend, backend=backend, queue_depth=queue_depth,
            rate_floor=rate_floor, fault_policy=fault_policy,
        )
        for summ in ckpt.load_summaries():
            for k, v in summ.items():
                parts.setdefault(k, []).append(v)
    for sl, batch, out in run_grid_stream(
        points, algorithms, chunk_size=chunk_size, mode=mode,
        backend=backend, trace_backend=trace_backend, prefetch=prefetch,
        queue_depth=queue_depth, rate_floor=rate_floor, donate=True, checkpoint=ckpt,
        fault_policy=fault_policy, tiling=tiling, device=device,
    ):
        summ = summarize_lifecycle(out, batch) if mode == "lifecycle" else summarize(out)
        if ckpt is not None:
            ckpt.commit(sl.start // chunk_size, summ)
        for k, v in summ.items():
            parts.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in parts.items()}


def grid_memory_bytes(
    cfg: trace.TraceConfig,
    G: int,
    *,
    mode: str = "slot",
    algorithms: Sequence[str] = ALGORITHMS,
    itemsize: int = 4,
    prefetch: int = 0,
) -> dict[str, int]:
    """Analytic estimate of a G-config grid's inputs, outputs and staged
    chunks.

    {"inputs": stacked spec/arrival/work bytes, "outputs": every
    algorithm's result tensors, "prefetch_buffers": staged chunks not yet
    consumed, "total": all of it}. For a stream, take G = chunk_size with
    ``prefetch`` its queue depth: beside the chunk in flight the pipeline
    holds up to ``prefetch`` queued chunks' inputs and one more the worker
    is building, ``prefetch + 1`` staged chunks. A LifecycleTrace row
    costs T (4 + 8 L + R K) floats against slot mode's T; the (T, K) fault
    input counts only when ``cfg.faults`` is active.

    The model leaves out the algorithms' step temporaries and the device
    trace synthesis's int64 hash words, so a stream's measured peak lies
    above ``total``: 5.8 times it for T=100, L=6, R=16, K=4, OGASCHED and
    FAIRNESS, chunk 256, prefetch 2, on an H100 (PERF.md). The peak is
    bounded by the chunk, not by the grid.
    """
    _check_mode(mode)
    L, R, K, T = cfg.L, cfg.R, cfg.K, cfg.T
    spec = L * R + L * K + 2 * R * K + 2 * K
    inputs = spec + T * L + 2  # + arrivals + (eta0, decay)
    per_alg = T  # slot-mode rewards
    if mode == "lifecycle":
        inputs += T * L  # works
        if cfg.faults.active:
            inputs += T * K  # fault capacity multipliers
        per_alg = T * (4 + 8 * L + R * K)  # LifecycleTrace fields
    in_b = G * inputs * itemsize
    out_b = G * per_alg * len(algorithms) * itemsize
    pre_b = (prefetch + 1) * in_b if prefetch else 0
    return {"inputs": in_b, "outputs": out_b, "prefetch_buffers": pre_b,
            "total": in_b + out_b + pre_b}


def improvement_pct(oga, base, eps: float = 1e-9):
    """Signed-safe percentage improvement of ``oga`` over ``base``:
    100 (oga - base) / max(|base|, eps), finite at zero baselines and
    sign-correct at negative ones."""
    oga = np.asarray(oga, np.float64)
    base = np.asarray(base, np.float64)
    return 100.0 * (oga - base) / np.maximum(np.abs(base), eps)


def summarize(rewards: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Per-config average rewards and OGASCHED's improvement percentages:
    {"avg/<name>": (G,), "improvement_pct/<name>": (G,)}, as
    ``simulator.improvement_over_baselines`` per grid row."""
    out = {f"avg/{n}": torch.as_tensor(r).cpu().numpy().mean(axis=1)
           for n, r in rewards.items()}
    if "ogasched" in rewards:
        oga = out["avg/ogasched"]
        for n in rewards:
            if n != "ogasched":
                out[f"improvement_pct/{n}"] = improvement_pct(oga, out[f"avg/{n}"])
    return out


def summarize_lifecycle(traces: dict, batch: SweepBatch) -> dict[str, np.ndarray]:
    """Per-config lifecycle metrics: {"<metric>/<name>": (G,)} for every
    scalar ``lifecycle.summarize`` reports, one batched reduction per
    algorithm (``lifecycle.summarize_batch``)."""
    out: dict[str, np.ndarray] = {}
    for name, tr in traces.items():
        for metric, v in lifecycle.summarize_batch(tr, batch.spec).items():
            out[f"{metric}/{name}"] = v.cpu().numpy()
    return out
