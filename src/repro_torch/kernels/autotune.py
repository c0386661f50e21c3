"""Launch constants of the CUDA kernels, and the shape-aware tuner that
picks their tiling per packed problem shape.

The one home of the integers that shape a kernel launch (the
``hardcoded-tiling`` lint rule allows them only in a module at this path).
Counterpart of ``repro.kernels.autotune``, for Hopper.

Layout. A row of L lanes, 1 <= L <= ``MAX_L``, has P = ``slots_for(L)``
breakpoint slots: the next power of two at or above 2L, and never below
one warp. Both projection methods lay a row out alike
(``csrc/sortscan.cuh``, ``csrc/bisect.cuh``): a row of L <= ``WIDE_L``
lanes is ``lanes_per_row(L)`` lanes of one warp, at L <= 16 half a warp,
so ``rows_per_warp(L)`` = 2. Each lane holds ``slots_per_lane(L)`` slots
in registers: the sortscan sorts them, the bisection keeps half as many
ports (z, a and m). A block holds ``row_block`` rows in whole warps and
uses no shared memory. A wider row is one block of ``WIDE_THREADS``
threads (the sortscan's slots in shared memory; the bisection's ports in
registers, up to MAX_L / WIDE_THREADS a thread), so its row block is 1 and
the tuner has nothing to choose.

``legal_row_block(row_block, L, method)`` is the launch test, the same for
both methods. The grid is ceil(N / row_block) blocks. Every row reduces
with its own lanes' shuffles, so a row's arithmetic, and hence its bits,
do not depend on ``row_block``.

Contract, in dispatch order:

* ``resolve(kernel, n, l)`` is the only entry the hot path calls. It reads
  the on-disk table through an in-memory view and returns
  ``DEFAULT_CONFIG`` on a miss. It never measures and never launches
  anything on the device (it reads the card's name once per process).
* ``tune(kernel, n, l)`` enumerates ``candidates()``, builds the kernel
  library, warms and times each candidate with CUDA events, and publishes
  the winner through ``ckpt.atomic_write_json`` (temp file, fsync, atomic
  rename, directory fsync), so a crash mid-store never tears the table.
* Keys bucket shapes (rows to the next power of two, lanes to the row's
  slots P: the block shape the kernels really run) and bind the device
  name, its compute capability, the torch and CUDA versions and the hash
  of the kernel sources. A table written by another card, toolchain or
  source is a clean miss; damaged or illegal entries read as misses.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build

# --------------------------------------------------------------------------
# Launch constants — the one place integer tile shapes may be spelled out.
# --------------------------------------------------------------------------

WARP = 32                 # threads per warp
MAX_THREADS = 1024        # threads a Hopper block may hold
# widest row: a wide sortscan row's 2 * 4096 slots take 96 KiB of shared
# memory, within the 227 KiB a Hopper block may opt in to
MAX_L = 4096
NARROW_L = 16             # sortscan rows of at most this many lanes: two per warp
WIDE_L = 256              # sortscan rows wider than this: one block a row
WIDE_THREADS = 512        # threads of a wide row's block
# threads of a projection block, so ptxas may give each up to 128 registers
SORTSCAN_MAX_THREADS = 512
# rows per block: powers of two up to a block of one-warp rows
ROW_BLOCKS = tuple(1 << i for i in range((MAX_THREADS // WARP).bit_length()))
DEFAULT_ROW_BLOCK = 1     # one block per row: the untuned layout
BISECT_ITERS = (12, 20, 28)         # bisect iteration-count candidates
DEFAULT_BISECT_ITERS = 20
MAX_BISECT_ITERS = 64
PROJ_METHODS = ("sortscan", "bisect")
DEFAULT_PROJ_METHOD = "sortscan"    # the exact breakpoint sweep
KERNELS = ("oga_step", "proj")
# Flash attention, float32 (csrc/flash_attention.cu, namespace f32): query
# rows (position, head) per block, keys per K/V tile, K/V tiles in flight,
# and a thread's microtile: rows x keys of S (the same rows of O). A fixed
# choice, not tuned; the C entry refuses a launch whose constants differ
# from these. At hd 128 the ring's two stages fill the 227 KB a block may
# opt in to. The head dims both flash kernels take: the multiples of 16
# from 16 to 128 (every config's and every reduced config's).
FLASH_BLOCK_ROWS = 128
FLASH_BLOCK_K = 64
FLASH_STAGES = 2
FLASH_MICRO_ROWS = 8
FLASH_MICRO_KEYS = 4
FLASH_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
# The bf16 flash kernel (tensor cores, the same file): query rows per block,
# keys per K/V tile in shared memory, and the K/V tiles in flight. Fixed
# too; its C entry refuses others.
FLASH_TC_BLOCK_Q = 128
FLASH_TC_BLOCK_K = 128
FLASH_TC_STAGES = 2
# The float32 flash backward (csrc/flash_attention_bwd.cu, namespace ffma:
# FFMA on register microtiles fed by a TMA ring, the float32 forward's
# design): a block's rows (keys for dK/dV; for dQ query rows (position,
# head), packed as the forward packs them), a streamed tile's rows (queries
# for dK/dV, keys for dQ), the streamed tiles in flight where both kernels'
# tiles fit the 227 KB a block may opt in to (hd <= 96; one stage at hd 112
# and 128), and a thread's microtile: block rows x streamed rows of a score
# tile (the same block rows of its accumulators). Fixed; its C entry
# refuses others.
FLASH_BWD_BLOCK_ROWS = 128
FLASH_BWD_TILE_ROWS = 64
FLASH_BWD_STAGES = 2
FLASH_BWD_MICRO_ROWS = 8
FLASH_BWD_MICRO_COLS = 4
# The bf16 flash backward (the same file, namespace tc: wgmma fed by TMA):
# a block's rows (keys for dK/dV, queries for dQ; two consumer warpgroups
# of 64), a streamed tile's rows (queries for dK/dV, keys for dQ), and the
# streamed tiles in flight. The row statistics' scratch is padded to whole
# blocks. Fixed; its C entry refuses others.
FLASH_BWD_TC_BLOCK_ROWS = 128
FLASH_BWD_TC_TILE_ROWS = 64
FLASH_BWD_TC_STAGES = 2
# warm-up launches before a candidate is timed, and timed launches
WARMUP_CALLS = 3
TUNE_REPEATS = 10
# An upper bound of the card's clock, to size the GPU spin that queues the
# timed launches ahead of the host (a slower clock only spins longer).
SPIN_CYCLES_PER_S = 2.0e9

TABLE_VERSION = 1
_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def slots_for(L: int) -> int:
    """Breakpoint slots of one row of ``L`` lanes: 32 at the Fig. 2 width
    L = 10, 256 at L = 100, 8192 at MAX_L. Raises above MAX_L."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"row width L={L} outside the kernels' range 1..{MAX_L} "
                         f"(MAX_L = {MAX_L})")
    return max(WARP, next_pow2(2 * L))


def rows_per_warp(L: int) -> int:
    """Sortscan rows one warp holds: 2 at L <= NARROW_L, else 1."""
    slots_for(L)
    return 2 if L <= NARROW_L else 1


def lanes_per_row(L: int) -> int:
    """Threads that hold one sortscan row: W lanes of a warp
    (``csrc/sortscan.cuh``), or WIDE_THREADS for a row wider than WIDE_L."""
    return WIDE_THREADS if L > WIDE_L else WARP // rows_per_warp(L)


def slots_per_lane(L: int) -> int:
    """Breakpoint slots each thread of a sortscan row holds: in registers
    (E), 2 at L <= 32 and P / 32 up to WIDE_L (8 at L = 100); in shared
    memory for a wide row, P / WIDE_THREADS (2 to 16)."""
    return slots_for(L) // lanes_per_row(L)


def _check_method(method: str) -> None:
    if method not in PROJ_METHODS:
        raise ValueError(f"method must be in {PROJ_METHODS}: {method!r}")


@functools.cache
def row_threads(L: int, method: str = DEFAULT_PROJ_METHOD) -> int:
    """Threads of one row, the ``threads`` the C entries take: the row's
    lanes, for either method."""
    _check_method(method)
    return lanes_per_row(L)


def block_threads(row_block: int, L: int, method: str = DEFAULT_PROJ_METHOD) -> int:
    """Threads of a block of ``row_block`` rows: whole warps (a lone row of
    16 lanes leaves half its warp idle)."""
    return -(-row_block * row_threads(L, method) // WARP) * WARP


@functools.cache
def legal_row_block(row_block: int, L: int, method: str = DEFAULT_PROJ_METHOD) -> bool:
    """Whether a block of ``row_block`` rows of width ``L`` launches with
    ``method``: a power of two in ROW_BLOCKS, and at most
    SORTSCAN_MAX_THREADS threads (so 1 for a wide row). Both methods take
    the same rule; ``legal_sortscan_launch`` in ``csrc/sortscan.cuh`` is the
    same test. Cached, as is ``row_threads``: every kernel launch asks
    both."""
    _check_method(method)
    return (row_block in ROW_BLOCKS
            and block_threads(row_block, L, method) <= SORTSCAN_MAX_THREADS)


class KernelConfig(NamedTuple):
    """One tiling point of a kernel launch."""

    row_block: int = DEFAULT_ROW_BLOCK
    method: str = DEFAULT_PROJ_METHOD
    iters: int = DEFAULT_BISECT_ITERS

    def to_dict(self) -> dict:
        return {"row_block": self.row_block, "method": self.method,
                "iters": self.iters}

    @property
    def label(self) -> str:
        tail = f"-it{self.iters}" if self.method == "bisect" else ""
        return f"rb{self.row_block}-{self.method}{tail}"


DEFAULT_CONFIG = KernelConfig()

# process-local state: in-memory table view + hit/miss/measurement counters
_table: Optional[dict] = None
_table_path: Optional[str] = None
_stats = {"hits": 0, "misses": 0, "measurements": 0}


# ------------------------------------------------------------ shape buckets --
def shape_bucket(n: int, l: int) -> tuple[int, int]:
    """(row bucket, lane bucket): rows to the next power of two, lanes to
    the row's slots P, so problem sizes that run the same block shape and
    about as many blocks share a winner."""
    return next_pow2(max(n, 1)), slots_for(l)


@functools.cache
def _cuda_tag(index: int) -> str:
    name = torch.cuda.get_device_name(index)
    major, minor = torch.cuda.get_device_capability(index)
    return f"{name}|sm{major}{minor}"


def device_tag(device: DeviceLike = None) -> str:
    """The card a table entry was measured on: name and compute capability
    (``none`` on a host without CUDA, where nothing can be measured)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "none"
    return _cuda_tag(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.cache
def _source_tag() -> str:
    return build.source_hash()


def cache_key(kernel: str, n: int, l: int, device: DeviceLike = None) -> str:
    nb, pb = shape_bucket(n, l)
    return (f"{kernel}|N{nb}xP{pb}|{device_tag(device)}|torch{torch.__version__}"
            f"|cuda{torch.version.cuda}|src{_source_tag()}")


# ---------------------------------------------------------- candidate space --
def candidates(
    kernel: str,
    n: int,
    l: int,
    methods: Sequence[str] = (DEFAULT_PROJ_METHOD,),
) -> list[KernelConfig]:
    """Legal tilings for a packed (n rows, l lanes) problem: every row block
    legal for the method up to the row bucket (more rows per block than the bucket
    holds only adds idle rows); the bisect method enumerates its iteration
    count too. Never empty: ``row_block = 1`` is legal at every width."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    nb, _ = shape_bucket(n, l)
    out: list[KernelConfig] = []
    for method in methods:
        _check_method(method)
        for rb in ROW_BLOCKS:
            if rb > nb or not legal_row_block(rb, l, method):
                continue
            if method == "sortscan":
                out.append(KernelConfig(rb, "sortscan", 0))
            else:
                out.extend(KernelConfig(rb, "bisect", it) for it in BISECT_ITERS)
    return out


# ------------------------------------------------------------ on-disk table --
def cache_path() -> str:
    base = os.environ.get(_CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-kernels"
    )
    return os.path.join(base, "autotune.json")


def reset_cache() -> None:
    """Drop the in-memory table view (the next lookup re-reads the disk)."""
    global _table, _table_path
    _table = None
    _table_path = None


def reset_stats() -> None:
    _stats.update(hits=0, misses=0, measurements=0)


def cache_stats() -> dict:
    return dict(_stats)


def measurement_count() -> int:
    return _stats["measurements"]


def _valid_entry(ent: object, l: int) -> Optional[KernelConfig]:
    """Parse one table entry defensively: anything malformed, or a row
    block that cannot launch at width ``l``, is a miss."""
    if not isinstance(ent, dict):
        return None
    rb, method, iters = ent.get("row_block"), ent.get("method"), ent.get("iters")
    if method not in PROJ_METHODS:
        return None
    if type(rb) is not int or not legal_row_block(rb, l, method):
        return None
    if type(iters) is not int or not 0 <= iters <= MAX_BISECT_ITERS:
        return None
    return KernelConfig(rb, method, iters)


def _read_table(path: str) -> Optional[dict]:
    """The table document at ``path``, or None when it is missing, torn or
    of another schema."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    if (isinstance(raw, dict) and raw.get("version") == TABLE_VERSION
            and isinstance(raw.get("entries"), dict)):
        return raw
    return None


def _load_table() -> dict:
    """The table's entries, re-read when the path changes; {} on any damage."""
    global _table, _table_path
    path = cache_path()
    if _table is None or _table_path != path:
        raw = _read_table(path)
        _table, _table_path = (raw["entries"] if raw else {}), path
    return _table


def lookup(kernel: str, n: int, l: int, device: DeviceLike = None) -> Optional[KernelConfig]:
    """The cached winner for this shape bucket on this card, or None."""
    return _valid_entry(_load_table().get(cache_key(kernel, n, l, device)), l)


def resolve(kernel: str, n: int, l: int, device: DeviceLike = None) -> KernelConfig:
    """Dispatch-time tiling: the cached winner, or ``DEFAULT_CONFIG`` on a
    miss. Never measures."""
    cfg = lookup(kernel, n, l, device)
    if cfg is None:
        _stats["misses"] += 1
        return DEFAULT_CONFIG
    _stats["hits"] += 1
    return cfg


def _store(kernel: str, n: int, l: int, cfg: KernelConfig, us: float,
           measured: dict, device: DeviceLike = None) -> None:
    """Publish a winner: read-modify-write the table through the atomic
    JSON path, then refresh the in-memory view."""
    path = cache_path()
    raw = _read_table(path) or {"version": TABLE_VERSION, "entries": {}}
    raw["entries"][cache_key(kernel, n, l, device)] = {
        **cfg.to_dict(), "us": float(us),
        "measured": {k: float(v) for k, v in measured.items()},
    }
    ckpt.atomic_write_json(path, raw)
    reset_cache()


# ------------------------------------------------------------- measurement --
def _bench_operands(kernel: str, n: int, l: int, device: torch.device):
    """Seeded operands of the shape: z ~ 5 N(0, 1), a ~ U(0.1, 4), full
    mask, c ~ U(0.5, 8); for the fused step also arrivals, k* rows and the
    packed scalars over the four Pallas utility kinds."""
    rng = np.random.default_rng(np.random.SeedSequence([0, n, l]))
    z = rng.normal(0.0, 1.0, (n, l)) * 5.0
    a = rng.uniform(0.1, 4.0, (n, l))
    mask = np.ones((n, l))
    c = rng.uniform(0.5, 8.0, n)
    put = lambda t: torch.as_tensor(np.asarray(t, np.float32), device=device)
    if kernel == "proj":
        return tuple(map(put, (z, a, mask, c)))
    x = rng.random((n, l)) < 0.7
    kstar = rng.random((n, l)) < 0.2
    from repro_torch.kernels import oga_step as _og

    scal = _og.pack_scal(put(np.full(n, 1.2)), put(np.full(n, 0.4)), put(c),
                         put(np.arange(n) % 4), put(np.full(n, 0.5)))
    return tuple(map(put, (z, a, mask, x, kstar))) + (scal,)


def _launcher(kernel: str, cfg: KernelConfig, operands) -> Callable[[], torch.Tensor]:
    from repro_torch.kernels import oga_step as _og
    from repro_torch.kernels import proj_bisect as _pb
    from repro_torch.kernels import sortscan as _ss

    if kernel == "proj" and cfg.method == "sortscan":
        return lambda: _ss.proj_sortscan(*operands, row_block=cfg.row_block)
    if kernel == "proj":
        return lambda: _pb.proj_bisect(*operands, row_block=cfg.row_block,
                                       iters=cfg.iters)
    if kernel == "oga_step":
        return lambda: _og.oga_step_fused(*operands, method=cfg.method,
                                          row_block=cfg.row_block,
                                          iters=cfg.iters or None)
    raise ValueError(f"unknown kernel {kernel!r}")


def device_time_ms(fn: Callable[[], object], repeats: int) -> float:
    """Device time of one call of ``fn`` in ms: after WARMUP_CALLS calls,
    ``repeats`` back-to-back calls are each timed between two CUDA events,
    queued behind a GPU spin long enough that the host's enqueue time does
    not show; the median. The one timing method behind the tuner's choices
    and ``chip_smoke.py``'s kernel times."""
    repeats = max(repeats, 1)
    for _ in range(WARMUP_CALLS):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(repeats + 1)]
    torch.cuda._sleep(int(3 * host_s * SPIN_CYCLES_PER_S))
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def _measure_config(kernel: str, cfg: KernelConfig, operands, repeats: int) -> float:
    """Device time of one launch of ``cfg`` in µs (``device_time_ms``); the
    library is built before any clock starts."""
    if operands[0].device.type != "cuda":
        raise RuntimeError("autotune measures on a CUDA card only")
    fn = _launcher(kernel, cfg, operands)
    build.build()
    _stats["measurements"] += 1
    return 1e3 * device_time_ms(fn, repeats)


def tune(
    kernel: str,
    n: int,
    l: int,
    *,
    methods: Sequence[str] = (DEFAULT_PROJ_METHOD,),
    cands: Optional[Sequence[KernelConfig]] = None,
    measure: Optional[Callable[[KernelConfig], float]] = None,
    repeats: int = TUNE_REPEATS,
    store: bool = True,
    device: DeviceLike = None,
) -> tuple[KernelConfig, dict[str, float]]:
    """Time every candidate tiling of this shape and cache the winner.

    ``measure`` may be injected (a fixed measurement table makes the winner
    deterministic); by default seeded operands are built once on ``device``
    (None: the CUDA card) and each candidate timed by ``_measure_config``.
    Ties go to the earlier candidate. ``store=False`` measures without
    publishing. Returns (winner, {config label: µs}).
    """
    cfg_list = list(cands) if cands is not None else candidates(
        kernel, n, l, methods=methods)
    if measure is None:
        operands = _bench_operands(kernel, n, l, resolve_device(device))
        measure = lambda cfg: _measure_config(kernel, cfg, operands, repeats)
    measured: dict[str, float] = {}
    best_cfg, best_us = None, float("inf")
    for cfg in cfg_list:
        us = float(measure(cfg))
        measured[cfg.label] = us
        if us < best_us:
            best_cfg, best_us = cfg, us
    if best_cfg is None:
        raise ValueError("no candidate to tune")
    if store:
        _store(kernel, n, l, best_cfg, best_us, measured, device)
    return best_cfg, measured
