"""Atomic JSON publish: the part of ``repro.ckpt.checkpoint`` the kernel
autotune table writes through.

Write protocol: serialize to a temp file in the target's directory, fsync
it, ``os.replace`` it into place, then fsync the directory. A reader sees
either the complete new document or the previous one, never a torn write.
Checkpoints of pytrees and their manager come with the streamed sweep
(ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

import json
import os
from typing import Any


def _fsync_dir(path: str) -> None:
    """Make a rename durable: fsync the containing directory (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish(tmp: str, final: str, directory: str) -> None:
    os.replace(tmp, final)
    _fsync_dir(directory)


def atomic_write_json(path: str, obj: Any) -> None:
    """Durably publish ``obj`` as JSON at ``path``: same-directory temp
    file, fsync, ``os.replace`` into place, fsync the directory."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp.{os.path.basename(path)}")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    _publish(tmp, path, directory)
