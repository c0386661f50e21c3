"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them.

Each ``.cu`` file is compiled on its own, all of them at once, into a
shared library with a plain C interface, for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <lib>.so <source>.cu

The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of every file in ``csrc/`` and of the flags, so
an edited source rebuilds at first use and an unchanged one loads the
library already built. ``ptxas`` reports each kernel's registers and
shared memory into a ``.log`` beside the library. The libraries are loaded
with ``ctypes``; kernel wrappers launch them on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

from repro_torch.device import nvcc_path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("oga_step.cu", "proj_bisect.cu", "flash_attention.cu", "flash_attention_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# seconds one nvcc may take before the build is declared hung
NVCC_TIMEOUT_S = 600
# nvcc runs this process has started, one a source compiled
# (``compat.CompilationCounter`` reads it)
compiles = 0


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return build_dir() / f"{Path(source).stem}_{source_hash()}.so"


def build() -> dict:
    """Compile every source whose library is missing, all at once.

    Returns {source: seconds its nvcc took} for the sources compiled in this
    call (an empty dict when every library was already built). Raises with
    nvcc's output when a compile fails. Each nvcc started adds one to
    ``compiles``.
    """
    global compiles
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      tmp, out, log)
        compiles += 1
    seconds, failed = {}, []
    for src, (proc, tmp, out, log) in procs.items():
        try:
            rc = proc.wait(timeout=NVCC_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        seconds[src] = time.perf_counter() - t0
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src} (nvcc exit {rc}):\n{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return seconds


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, built first if needed."""
    if source not in SOURCES:
        raise ValueError(f"unknown CUDA source {source!r}; known: {SOURCES}")
    build()
    return ctypes.CDLL(str(library_path(source)))
