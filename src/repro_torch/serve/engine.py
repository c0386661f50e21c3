"""Batched serving engine: continuous batching over a fixed slot pool.

Counterpart of ``repro.serve.engine``. Requests occupy batch slots; every
engine step decodes one token for ALL active slots in one ``serve_step``
with per-row positions. A request's prompt is fed one token per step; once
it is fed, each step appends one generated token. Finished slots (eos,
``max_new_tokens``, or the cache full) free at once and refill from the
queue mid-flight; the per-row kpos mask keeps rows at different depths
correct.

Each step copies the host's token and position buffers before they go to
the device, so a later step's writes can never reach an earlier step's
transfer, and reads the device once: one argmax (or one draw) over all
rows and one ``.tolist()``. Sampling draws from a ``torch.Generator``;
only greedy decoding (temperature 0) matches the reference token for
token. ``last_logits`` keeps the last step's logits (slots, vocab), float32,
for a caller that checks them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos: Optional[int] = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ArchConfig, params, slots: int = 4, cache_len: int = 128,
                 temperature: float = 0.0, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.slots, self.cache_len = slots, cache_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.cache = tf.init_cache(cfg, slots, cache_len, M.compute_dtype(cfg), self.device)
        self.pos = np.zeros(slots, np.int64)       # next position per slot
        self.pending = np.zeros(slots, np.int64)   # token to feed per slot
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.steps_run = 0
        self.last_logits: Optional[torch.Tensor] = None  # (slots, vocab) of the last step

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _reset_slot(self, s: int) -> None:
        """Invalidate a slot's cache rows for reuse (kpos sentinel)."""
        self.cache["kpos"][:, s] = tf.EMPTY_KPOS
        self.pos[s] = 0

    def _fill_slots(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self._reset_slot(s)
                self.active[s] = req
                req._fed = 0  # tokens of the prompt fed so far
                self.pending[s] = req.prompt[0]

    def _next_tokens(self, logits: torch.Tensor) -> list[int]:
        """One token per row, read back in one transfer."""
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self.gen)[:, 0].tolist()
        return logits.argmax(-1).tolist()

    def step(self) -> int:
        """One batched decode step across all slots; returns the number of
        active slots it decoded."""
        self._fill_slots()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        # copies: pending and pos are written below, while the transfer of
        # this step's values may still be in flight
        toks = torch.from_numpy(self.pending[:, None].copy()).to(self.device, non_blocking=True)
        pos = torch.from_numpy(self.pos.copy()).to(self.device, non_blocking=True)
        logits, self.cache = M.serve_step(self.params, self.cfg, self.cache, toks, pos)
        self.last_logits = logits
        self.steps_run += 1
        nxt_all = self._next_tokens(logits)
        for s in act:
            req = self.active[s]
            self.pos[s] += 1
            req._fed += 1
            if req._fed < len(req.prompt):  # still feeding the prompt
                self.pending[s] = req.prompt[req._fed]
                continue
            nxt = nxt_all[s]
            req.out.append(nxt)
            self.pending[s] = nxt
            if ((req.eos is not None and nxt == req.eos)
                    or len(req.out) >= req.max_new_tokens
                    or self.pos[s] >= self.cache_len):
                req.done = True
                self.active[s] = None
        return len(act)

    def run(self, max_iters: int = 10_000) -> None:
        it = 0
        while (self.queue or any(r is not None for r in self.active)) and it < max_iters:
            self.step()
            it += 1
