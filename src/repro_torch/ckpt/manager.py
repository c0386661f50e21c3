"""Checkpoint manager: rotation and corruption-tolerant resume.

Counterpart of ``repro.ckpt.manager``. Crash-safety invariants:

* Rotation counts **valid** checkpoints only: a burst of torn newest
  writes (a crash-looping node) can never evict the last checkpoint that
  restores.
* Torn steps older than the newest valid checkpoint are garbage
  (``latest_valid_step`` would never pick them over it) and are removed
  during rotation; a torn step *newer* than every valid one is left alone,
  as it cannot be told from a write in flight.
* Orphaned ``.tmp.*`` staging files (left by a crash mid-
  ``save_checkpoint``) are swept on init.
* ``keep=None`` disables rotation: the sweep checkpoint store keeps every
  chunk.
"""
from __future__ import annotations

import os
from typing import Any, Optional

from repro_torch.ckpt import checkpoint as C
from repro_torch.device import DeviceLike


class CheckpointManager:
    def __init__(self, directory: str, keep: Optional[int] = 3, every: int = 50):
        self.dir = directory
        self.keep = keep
        self.every = every
        os.makedirs(directory, exist_ok=True)
        self._sweep_orphans()

    def _sweep_orphans(self) -> None:
        """Remove ``.tmp.*`` staging files a crashed writer left behind."""
        for f in os.listdir(self.dir):
            if f.startswith(".tmp."):
                try:
                    os.remove(os.path.join(self.dir, f))
                except OSError:
                    pass

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        """Save at every ``every``-th step; None otherwise."""
        if step % self.every != 0:
            return None
        return self.save(step, tree)

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        p = C.save_checkpoint(self.dir, tree, step, extra=extra)
        self._rotate()
        return p

    def _remove_step(self, step: int) -> None:
        for suffix in (".npz", ".json"):
            try:
                os.remove(os.path.join(self.dir, f"step_{step:08d}{suffix}"))
            except OSError:
                pass

    def _rotate(self) -> None:
        if self.keep is None:
            return
        steps = C.available_steps(self.dir)
        valid = [s for s in steps if C.verify_checkpoint(self.dir, s)]
        drop = set(valid[: -self.keep] if self.keep else valid)
        if valid:
            # torn writes below the newest valid checkpoint can never be
            # restored over it: reclaim them
            drop |= {s for s in steps if s not in set(valid) and s < valid[-1]}
        for s in drop:
            self._remove_step(s)

    def latest_valid_step(self) -> Optional[int]:
        """The newest checkpoint that passes its manifest's checksum; torn
        writes are skipped."""
        for s in reversed(C.available_steps(self.dir)):
            if C.verify_checkpoint(self.dir, s):
                return s
        return None

    def restore(self, like: Any, device: DeviceLike = None):
        """(step, tree) of the newest valid checkpoint on ``device`` (None:
        the CUDA card), or (None, None)."""
        s = self.latest_valid_step()
        if s is None:
            return None, None
        return s, C.load_checkpoint(self.dir, s, like, device)
