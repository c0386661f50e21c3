"""What the benchmark takes from the program under test (``repro_torch``,
the PyTorch and CUDA port): its cluster type, its kernel build, its
autotune table. Imported only after ``run.py`` has put the checkout's
``src`` on the path; the reference never imports this module.
"""
from __future__ import annotations

import time

import torch


def cluster_spec(spec):
    """The program's ``ClusterSpec`` over the benchmark's tensors (the same
    storage: the program is handed the inputs, not a copy)."""
    from repro_torch.core.graph import ClusterSpec

    out = ClusterSpec(*(getattr(spec, f) for f in ClusterSpec.FIELDS))
    out.validate()
    return out


def prepare_kernels(device: torch.device, shapes) -> dict:
    """Build the program's CUDA libraries and tune every (kernel, rows,
    lanes) of ``shapes`` that its autotune table misses, so the window
    resolves every launch from the table. Nothing on the CPU. Returns the
    seconds each took and what was tuned."""
    info = {"build_s": 0.0, "tune_s": 0.0, "tuned": []}
    if device.type != "cuda":
        return info
    from repro_torch.kernels import autotune, build

    t0 = time.perf_counter()
    per_source = build.build()
    info["build_s"] = time.perf_counter() - t0
    info["compiled"] = sorted(per_source)
    t0 = time.perf_counter()
    for kernel, n, l in shapes:
        if autotune.lookup(kernel, n, l, device) is None:
            cfg, _ = autotune.tune(kernel, n, l, device=device)
            info["tuned"].append(f"{kernel}({n},{l})={cfg.label}")
    torch.cuda.synchronize(device)
    info["tune_s"] = time.perf_counter() - t0
    return info


def autotune_stats() -> dict:
    from repro_torch.kernels import autotune

    return autotune.cache_stats()


def reset_autotune_stats() -> None:
    from repro_torch.kernels import autotune

    autotune.reset_stats()
