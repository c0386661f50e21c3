"""Deterministic, host-sharded synthetic token pipeline.

Counterpart of ``repro.data.pipeline``. Each host takes only its shard of
the global batch; a batch is a pure function of (seed, step), drawn with
``np.random.default_rng((seed, step))``'s zipf calls exactly as the
reference draws it, so its tokens are the reference's bit for bit and a
restart at step k replays the same batches. A background thread
prefetches the stream. Batches are int64 tensors (torch's index type) on
the device the config names.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.2  # heavy-tailed token distribution (LM-like)


def _host_slice(cfg: DataConfig) -> tuple[int, int]:
    per = cfg.global_batch // cfg.n_hosts
    return cfg.host_index * per, per


def batch_at(cfg: DataConfig, step: int, device: DeviceLike = None) -> dict:
    """The step-th batch shard of this host on ``device`` (None: the CUDA
    card): {"tokens", "labels"} (per, seq_len), labels the tokens shifted
    by one. The whole global batch is drawn and this host's rows cut from
    it, so any host count gives the same global data."""
    start, per = _host_slice(cfg)
    rng = np.random.default_rng((cfg.seed, step))
    toks = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    rows = np.minimum(toks, cfg.vocab - 1)[start:start + per].astype(np.int64)
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(rows[:, :-1])).to(dev),
            "labels": torch.from_numpy(np.ascontiguousarray(rows[:, 1:])).to(dev)}


def stream(cfg: DataConfig, start_step: int = 0, device: DeviceLike = None) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, device)
        step += 1


class Prefetcher:
    """Background-thread prefetch of the deterministic stream, ``depth``
    batches ahead. ``close`` stops the thread and joins it. A batch waits
    for room in the queue (the reference's worker draws the next one when
    a put times out, so a slow consumer skips steps there)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device: DeviceLike = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        dev = resolve_device(device)

        def worker():
            it = stream(cfg, start_step, dev)
            while not self._stop.is_set():
                item = next(it)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5.0)
