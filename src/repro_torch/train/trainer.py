"""Trainer: checkpoint and restart, straggler tracking, gradient
compression.

Counterpart of ``repro.train.trainer``, on one device: the CUDA card unless
the caller names another (the tests run it on the CPU). A run draws its
batches with ``data.pipeline.batch_at(step)``, so a restart at step k
replays the same batches, and checkpoints {"params", "opt"} (and "err",
the compression residuals) through ``ckpt.CheckpointManager`` every
``ckpt_every`` steps. On the card every attention gradient goes through
the backward kernels, which add in a fixed order, so a resumed run repeats
an uninterrupted one bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import compression as gc
from repro_torch.train.train_step import make_train_step, value_and_grad


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    compress_grads: bool = False
    straggler_ewma: float = 0.9
    straggler_k: float = 3.0  # flag steps > k * sigma above the EWMA


class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps (a backup-dispatch
    signal). Each observation after the first is slow when it exceeds the
    mean by ``k`` standard deviations, the deviation floored at 5% of the
    mean so sub-noise jitter is never a straggler."""

    def __init__(self, alpha: float = 0.9, k: float = 3.0):
        self.alpha, self.k = alpha, k
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.flags: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        std = max(self.var ** 0.5, 0.05 * self.mean)
        slow = dt > self.mean + self.k * std
        d = dt - self.mean
        self.mean = self.alpha * self.mean + (1 - self.alpha) * dt
        self.var = self.alpha * self.var + (1 - self.alpha) * d * d
        if slow:
            self.flags.append(step)
        return slow


class Trainer:
    def __init__(self, cfg: ArchConfig, opt: AdamWConfig, data: DataConfig, tc: TrainConfig,
                 device: DeviceLike = None):
        self.cfg, self.opt, self.data, self.tc = cfg, opt, data, tc
        self.device = resolve_device(device)
        self.mgr = CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep, every=tc.ckpt_every)
        self.monitor = StragglerMonitor(tc.straggler_ewma, tc.straggler_k)
        self.step_fn = self._make_step()

    def _make_step(self):
        base = make_train_step(self.cfg, self.opt)
        if not self.tc.compress_grads:
            return base

        # the compressed data-parallel variant: the gradients go through
        # int8 with error feedback before the optimizer (what the
        # all-reduce would move)
        def step(params, opt_state, err, batch):
            loss, grads = value_and_grad(params, self.cfg, batch)
            q, err = gc.compress(grads, err)
            params, opt_state = adamw_update(self.opt, gc.decompress(q), opt_state, params)
            return params, opt_state, err, loss

        return step

    def init_or_resume(self, params: Optional[dict] = None):
        """(start step, state): the newest valid checkpoint's, else step 0
        from ``params`` (None: ``M.init_params(cfg, 0)`` on the device;
        a test passes the reference's own draw, carried across by
        ``convert.params_from_reference``) with a fresh optimizer state."""
        if params is None:
            params = M.init_params(self.cfg, 0, self.device)
        state = {"params": params, "opt": adamw_init(self.opt, params)}
        if self.tc.compress_grads:
            state["err"] = gc.init_state(params)
        step, restored = self.mgr.restore(state, self.device)
        if restored is not None:
            return step, restored
        return 0, state

    def run(self, hooks: Optional[dict] = None, params: Optional[dict] = None) -> dict:
        """Train from the newest checkpoint (or ``params``) to
        ``tc.steps``. ``hooks``: "on_step"(step, loss, seconds, slow) after
        each step; "inject_failure"(step) -> True raises after that step's
        update and before its checkpoint. Returns {"losses" (this run's,
        floats), "state", "straggler_flags"}."""
        hooks = hooks or {}
        start, state = self.init_or_resume(params)
        losses = []
        for step in range(start, self.tc.steps):
            batch = batch_at(self.data, step, self.device)
            t0 = time.perf_counter()
            if self.tc.compress_grads:
                p, o, e, loss = self.step_fn(state["params"], state["opt"], state["err"], batch)
                state = {"params": p, "opt": o, "err": e}
            else:
                p, o, loss = self.step_fn(state["params"], state["opt"], batch)
                state = {"params": p, "opt": o}
            loss = float(loss)  # waits for the step
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(step, dt)
            losses.append(loss)
            if "on_step" in hooks:
                hooks["on_step"](step, loss, dt, slow)
            if "inject_failure" in hooks and hooks["inject_failure"](step):
                # a node crash after the step, before its checkpoint
                raise RuntimeError(f"injected failure at step {step}")
            self.mgr.maybe_save(step + 1, state)
        return {"losses": losses, "state": state, "straggler_flags": self.monitor.flags}
