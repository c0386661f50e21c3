#!/usr/bin/env python3
"""Device times of the scheduler's kernels in one checkout, on one NVIDIA card.

Run on a machine with a CUDA card and nvcc:

    python3 tools/sortscan_bench.py [--root DIR] [--label NAME]

Imports ``repro_torch`` from DIR/src (by default the checkout this file
sits in), builds its kernels, and times them at the shapes and on the
inputs of ``chip_smoke.py``'s kernels phase (the same seeds): the fused
OGA step's sortscan method at (768, 10), (6144, 100) and (49152, 10) and
the standalone sortscan projection at (768, 10) and (6144, 100), each at
every row block the checkout's tuner offers; the bisect method of both at
the same shapes, 20 halvings, at every row block the checkout's tuner
offers for it, and at the wide rows (96 rows of L = 4096, one block a
row). Each time is the tuner's CUDA-event method
(``autotune.device_time_ms``), median of 25 calls. Then the host's time
of one call of the fused step's wrapper at (768, 10), 2000 calls queued
back to back, and of its C entry alone (median of 3 each), and the
host's wall time of one OGASCHED slot at the Fig. 2 and Fig. 5 configs of
chip_smoke.py (``simulator.run_all`` of OGASCHED alone, on an empty
autotune table, so one row per block; median of 3 runs). Prints one JSON
line.

Two checkouts compare only within one run on one card: unpack the other
(``git archive``) into a directory that .gitignore lists and run this for
each in turns, A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPS = 25
SLOT_RUNS = 3
CALLS = 2000


def step_inputs(rng, N, L):
    """chip_smoke.py's fused-step operands."""
    a = rng.uniform(0.5, 3.0, (N, L)).astype(np.float32)
    mask = (rng.random((N, L)) < 0.8).astype(np.float32)
    y = (np.minimum(rng.uniform(0.0, 2.0, (N, L)), a) * mask).astype(np.float32)
    x = (rng.random((N, L)) < 0.7).astype(np.float32)
    kstar = (rng.random((N, L)) < 0.2).astype(np.float32)
    scal = np.stack([
        rng.uniform(1.0, 1.5, N), rng.uniform(0.3, 0.5, N),
        rng.uniform(0.1, 0.8, N) * L, np.arange(N) % 7, np.full(N, 0.7),
    ], axis=1).astype(np.float32)
    return y, a, mask, x, kstar, scal


def proj_inputs(rng, N, L, loose_every=0):
    """chip_smoke.py's projection operands."""
    z = (rng.normal(0.0, 5.0, (N, L))).astype(np.float32)
    a = rng.uniform(0.1, 4.0, (N, L)).astype(np.float32)
    m = (rng.random((N, L)) < 0.8).astype(np.float32)
    c = rng.uniform(0.3, 6.0, N).astype(np.float32)
    dup = slice(0, N // 4)
    z[dup, 1::2] = z[dup, 0:L - 1:2]
    a[dup, 1::2] = a[dup, 0:L - 1:2]
    z[dup, 0] = a[dup, 0]
    m[N // 4: N // 4 + 8] = 0.0
    if loose_every:
        c[::loose_every] = 1e4
    return z, a, m, c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sortscan_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import autotune, build, ref
    from repro_torch.kernels import oga_step as og
    from repro_torch.kernels import proj_bisect as pb
    from repro_torch.kernels import sortscan as ss

    dev = torch.device("cuda")
    build.build()
    cuda = lambda arrays: [torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in arrays]
    ms = lambda fn: autotune.device_time_ms(fn, REPS)
    rbs = lambda kernel, N, L, method="sortscan": sorted(
        {c.row_block for c in autotune.candidates(kernel, N, L, methods=(method,))})
    seeds = np.random.SeedSequence(20261017).spawn(8)
    out = {"label": args.label or args.root, "torch": torch.__version__,
           "oga_step_fused": {}, "proj_sortscan": {}, "oga_step_bisect": {},
           "proj_bisect": {}}
    shapes = {"fig2": (768, 10), "fig5": (6144, 100), "grid64": (49152, 10)}
    for i, (label, (N, L)) in enumerate(shapes.items()):
        t = cuda(step_inputs(np.random.default_rng(seeds[i]), N, L))
        err = float((og.oga_step_fused(*t) - ref.oga_step_ref(*t)).abs().max())
        out["oga_step_fused"][label] = {
            "max_abs_err": err,
            "ms_by_row_block": {rb: ms(lambda: og.oga_step_fused(*t, row_block=rb))
                                for rb in rbs("oga_step", N, L)}}
        out["oga_step_bisect"][label] = {
            rb: ms(lambda: og.oga_step_fused(*t, method="bisect", row_block=rb))
            for rb in rbs("oga_step", N, L, "bisect")}
    for i, (label, (N, L)) in enumerate({"fig2": (768, 10), "fig5": (6144, 100)}.items()):
        z, a, m, c = proj_inputs(np.random.default_rng(seeds[4 + i]), N, L)
        t = cuda((z, a, m, c))
        err = float(np.abs(ss.proj_sortscan(*t).cpu().numpy()
                           - ref.proj_rows_exact_np(z, a, m, c)).max())
        out["proj_sortscan"][label] = {
            "oracle_err": err,
            "ms_by_row_block": {rb: ms(lambda: ss.proj_sortscan(*t, row_block=rb))
                                for rb in rbs("proj", N, L)}}
        tb = cuda(proj_inputs(np.random.default_rng(seeds[6 + i]), N, L, loose_every=5))
        out["proj_bisect"][label] = {rb: ms(lambda: pb.proj_bisect(*tb, row_block=rb))
                                     for rb in rbs("proj", N, L, "bisect")}
    # the wide rows of chip_smoke.py's kernels phase at L = 4096
    rng = np.random.default_rng([20261017, 2, 4096])
    z, a, m, c = proj_inputs(rng, 96, 4096, loose_every=5)
    c[1::7] = 0.0
    z[2::7] = 0.0
    tb = cuda((z, a, m, c))
    ts = cuda(step_inputs(rng, 96, 4096))
    ts[-1][1::7, 2] = 0.0
    out["proj_bisect"]["wide4096"] = {1: ms(lambda: pb.proj_bisect(*tb))}
    out["oga_step_bisect"]["wide4096"] = {
        1: ms(lambda: og.oga_step_fused(*ts, method="bisect", row_block=1))}
    # host time of one wrapper call at the Fig. 2 shape, launches queued
    # back to back (the host, not the card, sets the pace): what a slot pays
    t = cuda(step_inputs(np.random.default_rng(seeds[0]), 768, 10))
    call_us = []
    for _ in range(SLOT_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            og.oga_step_fused(*t)
        torch.cuda.synchronize()
        call_us.append((time.perf_counter() - t0) * 1e6 / CALLS)
    out["oga_step_fused_call_us"] = sorted(call_us)[SLOT_RUNS // 2]
    # the same launches through the C entry alone, its arguments made once:
    # the host cost below the wrapper's checks
    from repro_torch.kernels import _launch
    threads = (autotune.row_threads(10, "sortscan") if hasattr(autotune, "row_threads")
               else autotune.slots_for(10))
    entry = _launch._entry("oga_step.cu", "repro_oga_step", 7, 6)
    res = torch.empty_like(t[0])
    args = [x.data_ptr() for x in t] + [res.data_ptr(), 768, 10, threads, 1, 0, 20,
                                        torch.cuda.current_stream().cuda_stream]
    entry_us = []
    for _ in range(SLOT_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            entry(*args)
        torch.cuda.synchronize()
        entry_us.append((time.perf_counter() - t0) * 1e6 / CALLS)
    out["oga_step_c_entry_us"] = sorted(entry_us)[SLOT_RUNS // 2]
    from repro_torch.sched import simulator, trace

    slot_us = {}
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = tempfile.mkdtemp(prefix="sortscan-bench-")
    for label, cfg, kw in (
            ("fig2", trace.TraceConfig(T=2000, L=10, R=128, K=6, seed=1, contention=10.0), {}),
            ("fig5", trace.TraceConfig(T=300, L=100, R=1024, K=6, seed=7, contention=1.0,
                                       rho=0.95, beta_range=(0.01, 0.015)),
             {"eta0": 2.0, "decay": 0.9995})):
        runs = [simulator.run_all(cfg, algorithms=("ogasched",), **kw)["ogasched"].wall_s
                for _ in range(SLOT_RUNS)]
        slot_us[label] = sorted(runs)[SLOT_RUNS // 2] * 1e6 / cfg.T
    shutil.rmtree(os.environ["REPRO_TORCH_AUTOTUNE_CACHE"])
    out["ogasched_slot_us"] = slot_us
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
