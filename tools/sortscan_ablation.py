#!/usr/bin/env python3
"""The two water-level designs for rows of at most 16 lanes, on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/sortscan_ablation.py

Builds src/repro_torch/kernels/csrc/oga_step.cu as it is ("kernel": rows
of L <= 16 evaluate g at each lane's two breakpoints, no sort) and the
variant "network_narrow" (a text edit: those rows go through the bitonic
network and scans that rows of L > 16 use), each with nvcc into its own
library, and times the fused OGA step and the standalone projection of
each at (768, 10) and (49152, 10) at every legal row block, on the inputs
of chip_smoke.py's kernels phase, in turns (kernel, variant, variant,
kernel; each the median of 25 calls between CUDA events). Both must give
the plain version's result within chip_smoke.py's bars; whether the two
give the same bits is printed. Prints one JSON line with the card's name
and power limit. The variant is a text edit of the source: after a change
to the kernel it raises ValueError if the edit no longer applies.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "sortscan_ablation")
REPS = 25
SHAPES = {"fig2": (768, 10), "grid64": (49152, 10)}
OGA_STEP_ATOL = 1e-5      # chip_smoke.py's bars
PROJ_PLAIN_ATOL = 2e-6
NARROW = "  if constexpr (W < kWarp) {\n    return direct_water_level<W>("


def variants(src: str) -> dict:
    if NARROW not in src:
        raise ValueError(f"variant edit does not apply: {NARROW[:40]!r}")
    return {"kernel": src,
            "network_narrow": src.replace(NARROW, NARROW.replace("W < kWarp", "false"))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sortscan_ablation: no CUDA device", file=sys.stderr)
        return 2
    import sortscan_bench
    from repro_torch.device import nvcc_path
    from repro_torch.kernels import _launch, autotune, build, ref
    from repro_torch.kernels import oga_step as og
    from repro_torch.kernels import sortscan as ss

    os.makedirs(OUT, exist_ok=True)
    header = open(os.path.join(CSRC, "sortscan.cuh")).read()
    procs = {}
    for name, text in variants(header).items():
        vdir = os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        for f in os.listdir(CSRC):
            body = text if f == "sortscan.cuh" else open(os.path.join(CSRC, f)).read()
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(body)
        lib = os.path.join(vdir, "oga_step.so")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *build.NVCC_FLAGS, "-o", lib, os.path.join(vdir, "oga_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate(timeout=build.NVCC_TIMEOUT_S)[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(lib)

    current = {}

    def entry(source, symbol, argtypes):
        fn = getattr(libs[current["name"]], symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    real_entry = _launch.c_entry
    _launch.c_entry = entry
    dev = torch.device("cuda")
    cuda = lambda arrays: [torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in arrays]
    seeds = np.random.SeedSequence(20261017).spawn(8)
    runs = {}
    for label, (N, L) in SHAPES.items():
        step = cuda(sortscan_bench.step_inputs(np.random.default_rng(seeds[0]), N, L))
        proj = cuda(sortscan_bench.proj_inputs(np.random.default_rng(seeds[4]), N, L))
        rbs = [rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L)]
        for rb in rbs:
            runs[f"oga_step_fused {label} rb{rb}"] = (
                lambda t=step, rb=rb: og.oga_step_fused(*t, row_block=rb),
                ref.oga_step_ref(*step), OGA_STEP_ATOL)
            runs[f"proj_sortscan {label} rb{rb}"] = (
                lambda t=proj, rb=rb: ss.proj_sortscan(*t, row_block=rb),
                ref.proj_rows_sorted(*proj), PROJ_PLAIN_ATOL)
    try:
        errs, outs = {}, {}
        for name in libs:
            current["name"] = name
            for key, (fn, want, atol) in runs.items():
                got = fn()
                err = float((got - want).abs().max())
                if err > atol:
                    raise AssertionError(f"{name} {key}: max abs err {err} > {atol}")
                errs.setdefault(name, {})[key] = err
                outs.setdefault(name, {})[key] = got
        same_bits = {key: torch.equal(outs["kernel"][key], outs["network_narrow"][key])
                     for key in runs}
        times = {name: {key: [] for key in runs} for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            current["name"] = name
            for key, (fn, _, _) in runs.items():
                times[name][key].append(autotune.device_time_ms(fn, REPS))
    finally:
        _launch.c_entry = real_entry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "ms_turns": times, "max_abs_err_vs_plain": errs,
                      "same_bits_as_kernel": same_bits,
                      "timing": f"device time, median of {REPS} calls between CUDA events, "
                                f"variants in turns (forward, then reverse)"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
