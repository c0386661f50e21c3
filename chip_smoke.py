#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build    nvcc builds the kernels of src/repro_torch/kernels/csrc afresh.
  kernels  each CUDA kernel against its plain PyTorch version on the card
           (the projections also against the float64 oracle), at the shapes
           the main path gives it, with CUDA-event times and bounds; the
           fused step's bisect branch also against its sortscan method.
  autotune the kernel-tuning path: kernels.autotune.tune at the main path's
           shapes, stored in a fresh temporary cache; the bisect A/B at each
           winner's row block; and every legal row block of both sortscan
           kernels against row_block = 1, bit for bit.
  fig2     simulator.run_all at the paper's Fig. 2 config (Tab. 2), every
           average reward against the JAX reference's, the fused trajectory
           against the spec-level reference backend, and a profile of the
           OGASCHED slot.
  regret   run_all with the Thm. 1 regret certificate at Fig. 2.
  fig5     run_all at the paper's Fig. 5 large-scale config (T = 300).
  grid     sweep.make_grid -> build_batch -> run_grid -> summarize over 64
           Fig. 2 configs, one fused launch per step.

fig2 to grid run on the warmed cache and must make no measurement and
miss it never. The kernel launch counters are set to 0 before the autotune
path and read after it, and again for the main path (fig2 to grid). The
line before the last lists every kernel with its launches on each path
and their sum, its error and its times; the last line is {"ok": true, "device": {...}}.
A failed check raises, and the exit code is then non-zero. Needs no
network; imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
# float64 and float32 rates outside the tensor cores (the sortscan water
# level is solved in double, the bisection in float32).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12

# Average rewards of the JAX reference package on the CPU (jax 0.9.0),
# re-derived with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.sched import trace;
#     from repro.sched.simulator import run_all; r = run_all(trace.TraceConfig(
#     T=2000, L=10, R=128, K=6, seed=1, contention=10.0), with_regret=True);
#     print({n: v.avg_reward for n, v in r.items()}, r['ogasched'].regret)"
FIG2_REFERENCE = {
    "ogasched": 4922.69482421875,
    "drf": 4400.7841796875,
    "fairness": 4564.94873046875,
    "binpacking": 4331.27099609375,
    "spreading": 4325.31982421875,
}
FIG2_REFERENCE_REGRET = 327864.0
# The same for the Fig. 5 config below, with eta0=2.0, decay=0.9995
# (benchmarks/bench_large_scale.py, contention 1.0, T = 300).
FIG5_REFERENCE = {
    "ogasched": 86084.9140625,
    "drf": 85811.3828125,
    "fairness": 88922.4296875,
    "binpacking": 84799.40625,
    "spreading": 85430.9453125,
}
REWARD_RTOL = 1e-4          # average reward vs the reference
TRAJ_TOL = 1e-4             # per-slot |a - b| <= TRAJ_TOL * max|reward|
OGA_STEP_ATOL = 1e-5        # CUDA fused step vs its plain version
PROJ_ATOL = 1e-6            # CUDA projection vs the float64 oracle
# CUDA projection vs its float32 plain version: the plain sweep rounds the
# breakpoints z - a to float32 and is itself off the oracle by up to
# ~1.3e-6 at this input distribution (|z| up to ~25, on the CPU: 1.01e-6 at
# (768, 10), 1.31e-6 at (6144, 100)); the kernel is not.
PROJ_PLAIN_ATOL = 2e-6
# Every bisection result (the bisect kernel against its plain version and
# the oracle, the fused step's bisect branch against its plain version and
# the sortscan method): the reference's bar for its bisect kernel, the
# bracket width / 2^iters.
BISECT_ATOL = 5e-5
CAPACITY_SLACK = 1e-4       # sum(y) <= c + this for a bisection's output
TIMING_REPS = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="repro-torch-autotune-") as cache_dir:
        # a fresh autotune table: no earlier run's winners decide what runs
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_dir
        return smoke(torch)


def smoke(torch) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import ogasched
    from repro_torch.device import gpu_name_and_power_limit, platform_info
    from repro_torch.kernels import autotune, build, ops, ref
    from repro_torch.kernels import oga_step as og_kernel
    from repro_torch.kernels import proj_bisect as pb_kernel
    from repro_torch.kernels import sortscan as ss_kernel
    from repro_torch.sched import simulator, sweep, trace

    autotune.reset_cache()
    autotune.reset_stats()
    check(autotune.lookup("oga_step", 768, 10) is None, "the autotune cache is not empty")

    # no matmul or convolution runs here; pin full float32 all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    check(smi is not None, "nvidia-smi is missing")
    print(smi, flush=True)
    emit({"phase": "platform", **platform_info()})
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    shutil.rmtree(build.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    per_source = build.build()
    build_s = time.perf_counter() - t0
    check(set(per_source) == set(build.SOURCES), f"not every source was built: {per_source}")
    ptxas = {}
    for src in build.SOURCES:
        log = build.library_path(src).with_suffix(".log").read_text()
        ptxas[src] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": build_s, "per_source_s": per_source,
          "flags": list(build.NVCC_FLAGS), "ptxas": ptxas})

    # -------------------------------------------------------------- kernels
    seeds = np.random.SeedSequence(20261017).spawn(8)

    def time_ms(fn) -> float:
        """Device time of one call of ``fn``: the tuner's CUDA-event method,
        median of TIMING_REPS calls."""
        return autotune.device_time_ms(fn, TIMING_REPS)

    def call_ms(fn) -> float:
        """Host time of one call to its completion on the card (median of
        TIMING_REPS), launch overhead included."""
        times = []
        for _ in range(TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def cuda(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def step_inputs(rng, N, L):
        """Fused-step operands: all seven utility kinds, capacities that
        bind on most rows and not on others."""
        a = rng.uniform(0.5, 3.0, (N, L)).astype(np.float32)
        mask = (rng.random((N, L)) < 0.8).astype(np.float32)
        y = (np.minimum(rng.uniform(0.0, 2.0, (N, L)), a) * mask).astype(np.float32)
        x = (rng.random((N, L)) < 0.7).astype(np.float32)
        kstar = (rng.random((N, L)) < 0.2).astype(np.float32)
        scal = np.stack([
            rng.uniform(1.0, 1.5, N), rng.uniform(0.3, 0.5, N),
            rng.uniform(0.1, 0.8, N) * L, np.arange(N) % 7, np.full(N, 0.7),
        ], axis=1).astype(np.float32)
        return cuda(y, a, mask, x, kstar, scal)

    def proj_inputs(rng, N, L, loose_every=0):
        """The reference's projection-test distribution (test_kernels.py),
        with duplicated breakpoints, z = a lanes and fully masked rows; and
        with every ``loose_every``-th row's capacity too large to bind."""
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

    def oga_bytes(N, L):
        return 4 * N * (6 * L + 5)

    def proj_bytes(N, L):
        return 4 * N * (4 * L + 1)

    def proj_ops(N, L):
        """Float operations of the block-per-row sortscan on N rows: the
        bitonic network, two scans and six block reductions over P slots,
        plus the O(L) clip and recompute passes."""
        p = max(32, 1 << max(0, (2 * L - 1)).bit_length())
        lg = p.bit_length() - 1
        return N * (p // 2 * lg * (lg + 1) // 2 + 2 * p * lg + 6 * p + 12 * L)

    def bisect_ops(N, L, n_need, iters):
        """Float32 operations of the bisection on N rows: the box clip of
        every lane, and (iters + 4) clipped row sums on the n_need rows the
        capacity binds (the others leave after the first sum)."""
        return 4 * N * L + n_need * (iters + 4) * 5 * L

    def bound(nbytes, nops, ops_per_s=FP64_OPS_PER_S):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def feasible(y, a, m, c):
        """Largest violation of 0 <= y <= a, y = 0 on masked lanes and
        sum(y) <= c; raises past CAPACITY_SLACK on the sum."""
        over = float(((y * m).sum(1) - c).max())
        check(bool((y >= 0).all() and (y <= a).all() and (y[m == 0] == 0).all()),
              "a bisection left the box or a masked lane")
        check(over <= CAPACITY_SLACK, f"a bisection overshoots the capacity by {over}")
        return over

    shapes = {"fig2": (768, 10), "fig5": (6144, 100), "grid64": (49152, 10)}
    oga_rows = {}
    for i, (label, (N, L)) in enumerate(shapes.items()):
        args = step_inputs(np.random.default_rng(seeds[i]), N, L)
        got = ops.oga_step_fused(*args)
        want = ref.oga_step_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= OGA_STEP_ATOL, f"oga_step_fused {label} max abs err {err}")
        t_b, by = bound(oga_bytes(N, L), proj_ops(N, L) + 16 * N * L)
        oga_rows[label] = {
            "N": N, "L": L, "max_abs_err": err,
            "ms": time_ms(lambda: ops.oga_step_fused(*args)),
            "plain_ms": time_ms(lambda: ref.oga_step_ref(*args)),
            "call_ms": call_ms(lambda: ops.oga_step_fused(*args)),
            "plain_call_ms": call_ms(lambda: ref.oga_step_ref(*args)),
            "bound_ms": t_b, "bound_by": by, "bytes": oga_bytes(N, L),
        }
    bisect_pin = autotune.KernelConfig(autotune.DEFAULT_ROW_BLOCK, "bisect",
                                       autotune.DEFAULT_BISECT_ITERS)
    oga_bisect_rows = {}
    for i, (label, (N, L)) in enumerate(shapes.items()):
        args = step_inputs(np.random.default_rng(seeds[i]), N, L)
        got = ops.oga_step_fused(*args, tiling=bisect_pin)
        want = ref.oga_step_ref(*args, proj="bisect", iters=bisect_pin.iters)
        exact = ops.oga_step_fused(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_sortscan = float((got - exact).abs().max())
        check(err <= BISECT_ATOL, f"oga_step_fused bisect {label} max abs err {err}")
        check(err_sortscan <= BISECT_ATOL,
              f"oga_step_fused bisect {label} vs sortscan method {err_sortscan}")
        t_b, by = bound(oga_bytes(N, L), bisect_ops(N, L, N, bisect_pin.iters) + 16 * N * L,
                        FP32_OPS_PER_S)
        oga_bisect_rows[label] = {
            "N": N, "L": L, "iters": bisect_pin.iters, "max_abs_err": err,
            "vs_sortscan_max_abs": err_sortscan,
            "ms": time_ms(lambda: ops.oga_step_fused(*args, tiling=bisect_pin)),
            "plain_ms": time_ms(lambda: ref.oga_step_ref(*args, proj="bisect",
                                                         iters=bisect_pin.iters)),
            "bound_ms": t_b, "bound_by": by,
        }
    bisect_rows = {}
    for i, (label, (N, L)) in enumerate({"fig2": (768, 10), "fig5": (6144, 100)}.items()):
        z, a, m, c = proj_inputs(np.random.default_rng(seeds[6 + i]), N, L, loose_every=5)
        args = cuda(z, a, m, c)
        got = ops.proj_bisect(*args)
        plain = ref.proj_rows_bisect(*args)
        oracle = ref.proj_rows_exact_np(z, a, m, c)
        y = got.cpu().numpy()
        err = float((got - plain).abs().max())
        oracle_err = float(np.abs(y - oracle).max())
        check(err <= BISECT_ATOL, f"proj_bisect {label} max abs err vs plain {err}")
        check(oracle_err <= BISECT_ATOL, f"proj_bisect {label} max abs err vs oracle {oracle_err}")
        overshoot = feasible(y, a, m, c)
        n_need = int(((np.clip(z, 0.0, a) * m).sum(1) > c).sum())
        t_b, by = bound(proj_bytes(N, L), bisect_ops(N, L, n_need, autotune.DEFAULT_BISECT_ITERS),
                        FP32_OPS_PER_S)
        bisect_rows[label] = {
            "N": N, "L": L, "iters": autotune.DEFAULT_BISECT_ITERS, "rows_binding": n_need,
            "max_abs_err": err, "oracle_err": oracle_err, "capacity_overshoot": overshoot,
            "ms": time_ms(lambda: ops.proj_bisect(*args)),
            "plain_ms": time_ms(lambda: ref.proj_rows_bisect(*args)),
            "call_ms": call_ms(lambda: ops.proj_bisect(*args)),
            "plain_call_ms": call_ms(lambda: ref.proj_rows_bisect(*args)),
            "bound_ms": t_b, "bound_by": by, "bytes": proj_bytes(N, L),
        }
    proj_rows = {}
    # the shapes the paths run it at: the regret oracle's (768, 10), and
    # (6144, 100) where the autotune path tunes it
    for i, (label, (N, L)) in enumerate({"fig2": (768, 10), "fig5": (6144, 100)}.items()):
        z, a, m, c = proj_inputs(np.random.default_rng(seeds[4 + i]), N, L)
        args = cuda(z, a, m, c)
        got = ops.proj_sortscan(*args)
        plain = ref.proj_rows_sorted(*args)
        oracle = ref.proj_rows_exact_np(z, a, m, c)
        err = float((got - plain).abs().max())
        oracle_err = float(np.abs(got.cpu().numpy() - oracle).max())
        plain_oracle_err = float(np.abs(plain.cpu().numpy() - oracle).max())
        check(oracle_err <= PROJ_ATOL,
              f"proj_sortscan {label} max abs err vs float64 oracle {oracle_err}")
        check(err <= PROJ_PLAIN_ATOL, f"proj_sortscan {label} max abs err vs plain {err}")
        t_b, by = bound(proj_bytes(N, L), proj_ops(N, L))
        proj_rows[label] = {
            "N": N, "L": L, "max_abs_err": err, "oracle_err": oracle_err,
            "plain_oracle_err": plain_oracle_err,
            "ms": time_ms(lambda: ops.proj_sortscan(*args)),
            "plain_ms": time_ms(lambda: ref.proj_rows_sorted(*args)),
            "call_ms": call_ms(lambda: ops.proj_sortscan(*args)),
            "plain_call_ms": call_ms(lambda: ref.proj_rows_sorted(*args)),
            "bound_ms": t_b, "bound_by": by, "bytes": proj_bytes(N, L),
        }
    emit({"phase": "kernels", "row_block": autotune.DEFAULT_ROW_BLOCK,
          "oga_step_fused": oga_rows, "oga_step_fused_bisect": oga_bisect_rows,
          "proj_sortscan": proj_rows, "proj_bisect": bisect_rows,
          "oga_step_atol": OGA_STEP_ATOL, "proj_atol": PROJ_ATOL,
          "proj_plain_atol": PROJ_PLAIN_ATOL, "bisect_atol": BISECT_ATOL,
          "timing": f"ms: device time, median of {TIMING_REPS} back-to-back calls "
                    f"between CUDA events behind a GPU spin; call_ms: host time of "
                    f"one call to completion, median of {TIMING_REPS}"})

    # ------------------------------------------------------------- autotune
    wrappers = (og_kernel.oga_step_fused, ss_kernel.proj_sortscan, pb_kernel.proj_bisect)

    def zero_launches():
        for w in wrappers:
            w.launches = 0

    def launches():
        return tuple(w.launches for w in wrappers)

    zero_launches()
    t0 = time.perf_counter()
    default_label = autotune.DEFAULT_CONFIG._replace(iters=0).label
    tuned = {}
    for label, (N, L) in shapes.items():
        win, measured = autotune.tune("oga_step", N, L)
        check(autotune.lookup("oga_step", N, L) == win, f"oga_step {label}: winner not stored")
        ab_cands = [autotune.KernelConfig(win.row_block, "bisect", it)
                    for it in autotune.BISECT_ITERS]
        _, ab = autotune.tune("oga_step", N, L, cands=ab_cands, store=False)
        tuned[label] = {
            "N": N, "L": L, "us": measured, "winner": win.label,
            "speedup_vs_default": measured[default_label] / measured[win.label],
            "bisect_us": ab,
            "bisect_over_sortscan": {k: v / measured[win.label] for k, v in ab.items()},
        }
    tuned_proj = {}
    for label, (N, L) in {"fig2": (768, 10), "fig5": (6144, 100)}.items():
        # the table keeps sortscan winners only, as dispatch projects by it;
        # both methods side by side are measured without publishing
        win, measured = autotune.tune("proj", N, L)
        _, ab = autotune.tune("proj", N, L, methods=autotune.PROJ_METHODS, store=False)
        ss = {k: v for k, v in ab.items() if k.endswith("-sortscan")}
        bi = {k: v for k, v in ab.items() if "-bisect" in k}
        tuned_proj[label] = {
            "N": N, "L": L, "us": measured, "winner": win.label,
            "speedup_vs_default": measured[default_label] / measured[win.label],
            "ab_us": ab, "ab_winner": min(ab, key=ab.get),
            "bisect_over_sortscan": min(bi.values()) / min(ss.values()),
        }
    tune_s = time.perf_counter() - t0
    tune_launches = launches()
    for name, n in zip(("oga_step_fused", "proj_sortscan", "proj_bisect"), tune_launches):
        check(n > 0, f"{name} was not launched on the autotune path")
    # every legal row block of both sortscan kernels gives the bits of one
    # block per row, at every tuned shape and at a ragged row count
    bitwise = {}
    for i, (label, (N, L)) in enumerate(shapes.items()):
        for n in (N, N - 5):
            sargs = step_inputs(np.random.default_rng(seeds[i]), n, L)
            sargs[-1][::3, 2] = 1e4  # the capacity binds on two rows in three
            pargs = cuda(*proj_inputs(np.random.default_rng(seeds[4]), n, L, loose_every=3))
            base_s = og_kernel.oga_step_fused(*sargs, row_block=1)
            base_p = ss_kernel.proj_sortscan(*pargs, row_block=1)
            rbs = [c.row_block for c in autotune.candidates("oga_step", n, L)]
            for rb in rbs[1:]:
                same_s = torch.equal(og_kernel.oga_step_fused(*sargs, row_block=rb), base_s)
                same_p = torch.equal(ss_kernel.proj_sortscan(*pargs, row_block=rb), base_p)
                check(same_s and same_p,
                      f"row_block={rb} changes the bits at ({n}, {L}): "
                      f"oga_step_fused {same_s}, proj_sortscan {same_p}")
            bitwise[f"{n}x{L}"] = rbs
    emit({"phase": "autotune", "cache": "fresh temporary directory",
          "oga_step": tuned, "proj": tuned_proj, "seconds": tune_s,
          "measurements": autotune.measurement_count(),
          "launches": dict(zip(("oga_step_fused", "proj_sortscan", "proj_bisect"),
                               tune_launches)),
          "bitwise_equal_row_blocks": bitwise,
          "timing": f"us: device time per launch, median of {autotune.TUNE_REPEATS} "
                    f"launches between CUDA events behind a GPU spin"})

    # ------------------------------------------------------------ main path
    zero_launches()
    autotune.reset_stats()

    def check_rewards(res, reference, label):
        for name, want in reference.items():
            got = res[name].avg_reward
            rel = abs(got - want) / abs(want)
            check(rel <= REWARD_RTOL,
                  f"{label} {name}: average reward {got} vs reference {want} (rel {rel})")

    def per_slot_us(res, T):
        return {n: r.wall_s * 1e6 / T for n, r in res.items()}

    # fig2
    cfg2 = trace.TraceConfig(T=2000, L=10, R=128, K=6, seed=1, contention=10.0)
    n0 = launches()
    res2 = simulator.run_all(cfg2)
    n1 = launches()
    check(n1[0] - n0[0] == cfg2.T, f"fig2: {n1[0] - n0[0]} fused launches for T={cfg2.T}")
    check_rewards(res2, FIG2_REFERENCE, "fig2")
    check(res2["ogasched"].avg_reward == FIG2_REFERENCE["ogasched"],
          f"fig2: the tuned tiling moved the OGASCHED average to {res2['ogasched'].avg_reward}")
    spec2, arr2 = trace.make(cfg2)
    t0 = time.perf_counter()
    ref_rewards, _ = ogasched.run(spec2, arr2, eta0=25.0, decay=0.9999, backend="reference")
    ref_rewards = ref_rewards.cpu().numpy()
    ref_us = (time.perf_counter() - t0) * 1e6 / cfg2.T
    check(launches() == n1, "the reference backend launched a kernel")
    fused = res2["ogasched"].rewards
    traj_err = float(np.abs(ref_rewards - fused).max())
    check(traj_err <= TRAJ_TOL * float(np.abs(fused).max()),
          f"fig2: fused vs reference backend per-slot error {traj_err}")
    # where one OGASCHED slot's time goes: device time by kernel, 100 slots
    from torch.profiler import ProfilerActivity, profile
    sub = arr2[:100]
    ogasched.run(spec2, sub, eta0=25.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ogasched.run(spec2, sub, eta0=25.0)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev_us, kernel_us, n_dev = 0.0, 0.0, 0
    for ev in prof.key_averages():
        t = float(getattr(ev, "self_device_time_total", 0.0) or
                  getattr(ev, "self_cuda_time_total", 0.0) or 0.0)
        if t > 0:
            dev_us += t
            n_dev += ev.count
            if "oga_step_kernel" in ev.key:
                kernel_us += t
    slot_profile = {
        "slots": 100, "wall_us_per_slot": window_us / 100,
        "device_busy_us_per_slot": dev_us / 100 if dev_us else None,
        "oga_step_kernel_us_per_slot": kernel_us / 100 if dev_us else None,
        "device_ops_per_slot": n_dev / 100 if dev_us else None,
        "idle_share": 1.0 - dev_us / window_us if dev_us else None,
    }
    emit({"phase": "fig2", "config": "T=2000 L=10 R=128 K=6 seed=1 contention=10",
          "tiling": autotune.lookup("oga_step", 768, 10).label,
          "avg_reward": {n: r.avg_reward for n, r in res2.items()},
          "reference": FIG2_REFERENCE, "per_slot_us": per_slot_us(res2, cfg2.T),
          "reference_backend_per_slot_us": ref_us,
          "fused_vs_reference_backend_max_abs": traj_err,
          "fused_launches": n1[0] - n0[0], "ogasched_slot_profile": slot_profile})

    # regret
    n0 = launches()
    t0 = time.perf_counter()
    res_r = simulator.run_all(cfg2, algorithms=("ogasched",), with_regret=True)
    regret_s = time.perf_counter() - t0
    n1 = launches()
    oga = res_r["ogasched"]
    check(n1[0] - n0[0] == cfg2.T, "regret: fused launches != T")
    check(n1[1] - n0[1] == 2000, f"regret: {n1[1] - n0[1]} projection launches for 2000 oracle steps")
    check_rewards(res_r, {"ogasched": FIG2_REFERENCE["ogasched"]}, "regret")
    check(oga.regret <= oga.regret_bound, f"R_T {oga.regret} above H_G sqrt(T) {oga.regret_bound}")
    emit({"phase": "regret", "R_T": oga.regret, "bound": oga.regret_bound,
          "reference_R_T": FIG2_REFERENCE_REGRET, "oracle_iters": 2000,
          "seconds": regret_s, "projection_launches": n1[1] - n0[1]})

    # fig5
    cfg5 = trace.TraceConfig(T=300, L=100, R=1024, K=6, seed=7, contention=1.0,
                             rho=0.95, beta_range=(0.01, 0.015))
    n0 = launches()
    res5 = simulator.run_all(cfg5, eta0=2.0, decay=0.9995)
    n1 = launches()
    check(n1[0] - n0[0] == cfg5.T, "fig5: fused launches != T")
    check_rewards(res5, FIG5_REFERENCE, "fig5")
    emit({"phase": "fig5", "config": "T=300 L=100 R=1024 K=6 seed=7 contention=1 rho=0.95",
          "avg_reward": {n: r.avg_reward for n, r in res5.items()},
          "reference": FIG5_REFERENCE, "per_slot_us": per_slot_us(res5, cfg5.T),
          "fused_launches": n1[0] - n0[0]})

    # grid
    T_grid = 200
    grid_algorithms = ("ogasched", "fairness")
    points = sweep.make_grid(trace.TraceConfig(T=T_grid, L=10, R=128, K=6, contention=10.0),
                             seeds=range(64))
    batch = sweep.build_batch(points)
    spec_g, arr_g = batch.spec, batch.arrivals
    n0 = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_g = sweep.run_grid(batch, ("ogasched",))
    rewards_g = out_g["ogasched"].cpu().numpy()
    grid_us = (time.perf_counter() - t0) * 1e6 / T_grid
    n1 = launches()
    check(n1[0] - n0[0] == T_grid, f"grid: {n1[0] - n0[0]} launches for {T_grid} steps")
    check(rewards_g.shape == (64, T_grid) and np.isfinite(rewards_g).all(),
          "grid: rewards not finite or of the wrong shape")
    grid_err = []
    for g in (0, 1):
        single, _ = ogasched.run(spec_g[g], arr_g[g], eta0=25.0, decay=0.9999)
        single = single.cpu().numpy()
        err = float(np.abs(single - rewards_g[g]).max())
        check(err <= TRAJ_TOL * float(np.abs(single).max()), f"grid row {g}: error {err}")
        grid_err.append(err)
    # the tuned row block against one block per row, in turns on this card
    turns = {"tuned": [grid_us], "rb1": []}
    for key in ("rb1", "rb1", "tuned"):
        pin = autotune.DEFAULT_CONFIG if key == "rb1" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = sweep.run_grid(batch, ("ogasched",), tiling=pin)["ogasched"]
        torch.cuda.synchronize()
        turns[key].append((time.perf_counter() - t0) * 1e6 / T_grid)
        check(np.array_equal(again.cpu().numpy(), rewards_g),
              f"grid: the {key} tiling changed the rewards")
    t0 = time.perf_counter()
    out_g.update(sweep.run_grid(batch, grid_algorithms[1:]))
    summary = sweep.summarize({n: out_g[n] for n in grid_algorithms})
    heuristics_s = time.perf_counter() - t0
    for key, v in summary.items():
        check(v.shape == (64,) and np.isfinite(v).all(), f"grid: summary {key} not finite")
    check(np.allclose(summary["avg/ogasched"], rewards_g.mean(axis=1), rtol=1e-6, atol=0),
          "grid: summarize disagrees with the rewards")
    emit({"phase": "grid", "configs": 64, "T": T_grid, "per_step_us": grid_us,
          "per_step_us_turns": turns,
          "tiling": autotune.lookup("oga_step", 64 * 768, 10).label,
          "launches_per_step": (n1[0] - n0[0]) / T_grid, "row_vs_single_max_abs": grid_err,
          "algorithms": list(grid_algorithms), "heuristics_seconds": heuristics_s,
          "summary_mean": {k: float(v.mean()) for k, v in summary.items()}})

    stats = autotune.cache_stats()
    check(stats["measurements"] == 0 and stats["misses"] == 0,
          f"the warmed main path measured or missed the autotune cache: {stats}")

    # ---------------------------------------------------------- kernel line
    counts = launches()
    for name, n in zip(("oga_step_fused", "proj_sortscan"), counts):
        check(n > 0, f"{name} was not launched on the main path")
    emit({"phase": "paths", "autotune_cache": stats,
          "launches": {"autotune": dict(zip(("oga_step_fused", "proj_sortscan", "proj_bisect"),
                                            tune_launches)),
                       "main": dict(zip(("oga_step_fused", "proj_sortscan", "proj_bisect"),
                                        counts))}})
    csrc = "src/repro_torch/kernels/csrc/"

    def by_path(i):
        """A kernel's launches on each path; "launches" is their sum."""
        return {"main": counts[i], "autotune": tune_launches[i]}

    emit({"kernels": [
        {"name": "oga_step_fused", "route": "cuda", "source": csrc + "oga_step.cu",
         "replaces": "src/repro/kernels/oga_step.py:107",
         "launches": counts[0] + tune_launches[0],
         "launches_by_path": by_path(0),
         "max_abs_err": max(r["max_abs_err"] for r in oga_rows.values()),
         "ms": oga_rows["fig2"]["ms"], "plain_ms": oga_rows["fig2"]["plain_ms"],
         "bound_ms": oga_rows["fig2"]["bound_ms"], "bound_by": oga_rows["fig2"]["bound_by"],
         "library_ms": None},
        {"name": "proj_sortscan", "route": "cuda", "source": csrc + "oga_step.cu",
         "replaces": "src/repro/kernels/sortscan.py:171",
         "launches": counts[1] + tune_launches[1],
         "launches_by_path": by_path(1),
         "max_abs_err": max(r["max_abs_err"] for r in proj_rows.values()),
         "ms": proj_rows["fig2"]["ms"], "plain_ms": proj_rows["fig2"]["plain_ms"],
         "bound_ms": proj_rows["fig2"]["bound_ms"], "bound_by": proj_rows["fig2"]["bound_by"],
         "library_ms": None},
        {"name": "proj_bisect", "route": "cuda", "source": csrc + "proj_bisect.cu",
         "replaces": "src/repro/kernels/proj_bisect.py:89",
         "launches": counts[2] + tune_launches[2],
         "launches_by_path": by_path(2),
         "max_abs_err": max(r["max_abs_err"] for r in bisect_rows.values()),
         "ms": bisect_rows["fig2"]["ms"], "plain_ms": bisect_rows["fig2"]["plain_ms"],
         "bound_ms": bisect_rows["fig2"]["bound_ms"], "bound_by": bisect_rows["fig2"]["bound_by"],
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
