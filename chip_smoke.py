#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  lint     the port's lint (repro_torch.analysis.lint, every rule) over
           src/repro_torch and this script in the checkout: no finding, in
           at most LINT_SECONDS_BAR seconds.
  build    nvcc builds the kernels of src/repro_torch/kernels/csrc afresh,
           one nvcc a source (compat.CompilationCounter: 4; no later phase
           may compile, which the script checks at its end);
           ptxas's report of every kernel (the float32 flash kernel's by
           head dim: no spill at hd 128; every flash backward kernel's:
           none may spill or touch local memory, and each bf16 dK/dV and
           dQ kernel holds HGMMA and UTMALDG instructions), and for every
           sortscan and
           bisect instantiation its registers, shared memory, stack and
           spills and its SASS count of barriers, shared- and local-memory
           ops and shuffles (none may spill or touch local memory; the
           kernels of rows of L <= 256 use no barrier and no shared
           memory).
  kernels  each CUDA kernel against its plain PyTorch version on the card
           (the projections also against the float64 oracle), at the shapes
           the main, stream and extensions paths give it, with CUDA-event times, bounds and the
           launch floor (an empty kernel on the launch's grid); the sortscan
           kernels also at every legal row block; the fused step's bisect
           branch also against its sortscan method; proj_bisect bit for bit
           against a float32 emulation of its sums' order (the copy of
           tests/_bisect_network.py below) at widths 1 to 4096.
  autotune the kernel-tuning path: kernels.autotune.tune at the main,
           stream and extensions paths' shapes, stored in a fresh temporary
           cache (the extension shapes' tuned times); the bisect A/B at each
           winner's row block (both methods take the same row blocks); and
           every legal row block of the four projection kernels (both
           methods, fused and standalone) against row_block = 1, bit for
           bit.
  fig2     simulator.run_all at the paper's Fig. 2 config (Tab. 2), every
           average reward against the JAX reference's, the fused trajectory
           against the spec-level reference backend, 100 OGASCHED slots
           under compat.sync_guard("error") (a host sync raises), and a
           profile of the OGASCHED slot.
  regret   run_all with the Thm. 1 regret certificate at Fig. 2.
  fig5     run_all at the paper's Fig. 5 large-scale config (T = 300).
  grid     sweep.make_grid -> build_batch -> run_grid -> summarize over 64
           Fig. 2 configs, one fused launch per step.
  flash    both flash-attention kernels against their plain version (o
           with the row log-sum-exp written bit for bit o without it, the
           lse against the plain version's, at the small cases and the
           path shapes): the reference tests' shapes (plus hd 80, windows, softcaps, S = 1,
           S around one 128-row tile, a ragged 8191, hd 16, 48 and 112, and
           GQA rep 5 (25 query heads, window 1024) and 7) in float32 (the
           FFMA kernel) and bf16 (the tensor-core kernel), the full-width
           prefill shapes of dbrx, kimi, hymba, qwen2-vl and musicgen at
           4096 tokens in bf16 (times, bounds and SDPA beside them), and
           gemma2-27b's prefill shape, global and with window 4096, in
           bf16 and in float32, with CUDA-event times, the bound, the
           special-function floor of the softmax (sfu_floor_ms, bf16), the
           launch floor (float32: an empty kernel on its grid) and the time
           of torch's scaled_dot_product_attention without the softcap
           beside the kernel's on the same inputs (causal, and with the
           window as a boolean mask), in both dtypes; ptxas's registers and
           spills of both kernels, and the count of HGMMA and UTMALDG
           instructions in the built library.
  reduced_lm  model.prefill of reduced(gemma2-27b) and reduced(stablelm-3b)
           as they are (float32, head dim 16) on the card against the same
           call on the CPU, through the float32 kernel; the reduced configs
           of the other six (MoE, SSM, hybrid, vlm with 8 patches, audio)
           prefilled and decoded 8 tokens, card against CPU; and
           reduced(stablelm-3b) with the int8 KV cache, prefilled and
           decoded 8 tokens, card against CPU.
  lifecycle the job lifecycle at benchmarks/bench_lifecycle.py's
           configuration (L 10, R 128, K 6, work_mean 1200, seed 0; T cut
           from 2000 to 1000):
           OGASCHED, the four heuristics and MULTICLASS through
           lifecycle.run, each with its µs per slot and summarize's metrics
           against the JAX reference's (LIFECYCLE_REFERENCE, with the port's
           y0), the first slot where its admitted / departed record leaves
           the reference's (tools/lifecycle_reference_events.json), the
           capacity every slot, the launches (one fused step and one
           projection at (768, 10) a OGASCHED slot), the duration-1
           reduction to slot mode, and a profile of 100 OGASCHED slots.
  faults   benchmarks/bench_faults.py's quick configuration (L 10, R 64,
           work_mean 600; T cut to 500) under its four fault regimes, one
           worker process of this script a regime (--faults-worker), the
           four at once: OGASCHED, the heuristics and heSRPT, goodput,
           wasted work, evictions, fault drops and recovery_time against
           FAULTS_REFERENCE, and the surviving capacity every slot. The
           workers run beside the lifecycle phase's six runs and are
           collected before its duration-1 check and slot profile; their
           slot times are taken beside each other and those runs.
  grid_lifecycle  sweep.run_grid(mode="lifecycle") over 8 of the grid's 64
           Fig. 2 configs at T 200, faults off and on, each row against
           simulator.run_all(mode="lifecycle") of its config.
  stream   benchmarks/bench_sweep.py's streamed grids (L 6, R 16, K 4,
           T 100; OGASCHED and FAIRNESS): sweep_stream's loop over
           10000 slot-mode configs in chunks of 256, "auto" resolving to
           traces synthesized on the card (configs/s, overlap_ratio, peak
           memory against grid_memory_bytes, 40 x 100 fused launches at
           (16384, 6), the padded last chunk against a resident run); the
           lifecycle grid (2000 configs) in chunks of 32 on device traces;
           a profile of one chunk of each; host traces over the grid
           phase's 64 configs in chunks of 16, OGASCHED's rows bit for bit
           the grid phase's; device traces of 8 configs on the card
           against the CPU (hash words and spec bit for bit).
  resume   sweep_stream(checkpoint_dir=...) over 2048 of those configs in
           a subprocess (this script with --resume-worker), killed with
           SIGKILL once 2 chunks verify and resumed in a fresh process:
           the surviving chunks untouched, the summaries bit for bit an
           uninterrupted run's, a store of another grid refused.
  regret_validation  benchmarks/bench_regret.py's quick Theorem-1 grid
           (T 2048, 7 utilities x 2 regimes x 4 seeds, chunks of 16, 1500
           oracle steps) through core.regret.regret_validation: every
           cell against the JAX reference's pinned readings
           (REGRET_REFERENCE), bound_ok true in every cell.
  extensions  the paper's §3.4 at Fig. 2's config with Poisson counts
           (90 virtual ports; the J = 1 expansion of Fig. 2's trace bit for
           bit the fig2 phase's OGASCHED rewards), §3.5 gang scheduling on
           Fig. 2's spec over 500 slots (feasible and All-or-Nothing every
           slot, kept-port masks and Σ q_t against the reference's pins),
           §3.2's sharded step at launch/dryrun.py's scheduler cell (L 100,
           R 131072, K 6) on 1 and 4 shards of the card against the
           unsharded fused step (ms a step, peak memory; the dry run's
           sched cell at 4 shards: one position's argument bytes equal to
           the shard's tensors), and the job
           manager on examples/elastic_cluster.py's scenario (grants and
           meshes equal to the reference's, EXTENSIONS_REFERENCE from
           tests/_extensions_pins.py); the fused kernel's launches by shape.
  lm_prefill  the LM serving path at gemma2-27b's full width: first the
           float32 check at 2 layers (prefill(S - 1) + serve_step against
           prefill(S)), then all 46 layers in bf16 from seeded random
           weights: prefill of one 8192-token prompt (timed, peak memory)
           and the same decode-after-prefill check, with the bf16 KV cache
           and with the int8 one (kv_cache_quant=True; its bytes against
           the int8 + scale arithmetic); launch/dryrun.py's prediction of
           that prefill on meta tensors: its parameter bytes equal to the
           held ones, its peak over the measured one within
           DRYRUN_PEAK_RATIO_BARS.
  lm_serve the continuous-batching Engine on those weights: 8 greedy
           requests over 4 slots, each first token against prefill's; the
           same requests on the int8 KV cache (tokens recorded beside the
           bf16 cache's, the cache's bytes (hd + 4) / (2 hd) of bf16's).
  lm_families  gemma's weights freed, the other six configs at full width
           in bf16 from seeded random weights (dbrx-132b cut to 8 of 40
           layers and kimi-k2-1t-a32b to 1 of 61, as far as the card
           forces): a float32 check at 2 layers (all but kimi), a timed
           prefill of 4096 tokens (qwen2-vl: 256 patches + 3840 tokens;
           ms, tokens/s, peak memory, flash launches = attention layers),
           decode against prefill by family (musicgen: prefill(S - 1) + a
           step; MoE at the no-drop capacity factor E / k: the same at 256
           tokens; mamba2 and hymba: prefill(S - 256) + 256 teacher-forced
           steps against forward(S); qwen2-vl: the kernel's prefill
           against the plain attention's), the MoE layer against its
           expert-parallel local step (kept pairs exact) and against
           apply_moe_ep over a (data 1, model 4) mesh of the card (dbrx)
           or (1, 8) (kimi) (kept pairs exact; float32 within
           MOE_ORACLE_RTOL, bf16 recorded), and the Engine
           (8 requests over 4 slots, each against the same request alone in
           a fresh Engine; musicgen's and MoE's first tokens also against
           prefill's).
  train    the training slice. First the flash backward kernels
           (csrc/flash_attention_bwd.cu; bf16 on wgmma and TMA, float32 in
           FFMA on register microtiles fed by a TMA ring, both fed the
           forward's lse) against their plain version
           on the card (bf16: against the emulation of its arithmetic,
           ref.flash_attention_bwd_emulation), in float32 and bf16, at
           BWD_SMALL_CASES and at stablelm-3b's training shape and
           gemma2-27b's global layer (with and without its 4096 window),
           two launches bit for bit, the forward's o with and without the
           lse bit for bit, with times, the bound and SDPA's backward at
           the last three (float32 rows also the seven-product FFMA time,
           computed from the shape: what its design can reach; and, in bf16 at stablelm-3b's shape, SDPA's
           gradient's distance from the float32 plain one beside the
           emulation's).
           Then the train path: stablelm-3b at full width and 2 layers,
           loss and backward through the kernels against the plain
           attention pair (float32 and bf16; wq, wk and wv get gradients);
           stablelm-3b at full width and depth in bf16 through
           launch/train.py's build and the Trainer (4 x 4096 tokens, 1 +
           3 steps: ms a step, tokens/s, peak memory, 2 x 32 forward and
           32 backward calls (3 kernels each) a step, one step under the profiler for
           the backward kernels' share; the dry run's prediction of that
           step, its parameter and optimizer bytes equal to the Trainer's,
           its peak over the measured one within DRYRUN_PEAK_RATIO_BARS),
           and on the parameters it trained
           (part "mesh"): models.pipeline at 32 layers on 4 stages of the
           card in bf16 (bit for bit stack_forward over its microbatches,
           gradients within 2 bf16 ulps, the flash launches counted) and
           at 4 layers in float32 (against stack_forward over the whole
           batch), moe.apply_mlp_ep at tp 4 against swiglu_apply, and
           launch.elastic's reshard and rescale_checkpoint from a (8, 1)
           mesh of the card onto (2, 4), bit for bit; every family's
           reduced config, one train step on the card against the CPU; the Trainer's
           restart on the card, bit for bit; 25 steps with compressed
           gradients.

The kernels phase also holds both sortscan kernels and both bisect kernels
at the wide rows (L 257 to 4096, one block a row), with rows of zero
capacity and of z = 0 that must come back exactly 0.

added_parts  the seconds of the dry-run predictions against
           ADDED_PARTS_BUDGET_S, and the compiles after build (0).

fig2 to grid run on the warmed cache and must make no measurement and
miss it never. The kernel launch counters are set to 0 before the autotune
path and read after it, again for the main path (fig2 to grid), again for
the lifecycle path (lifecycle, faults and grid_lifecycle), again for the
stream path (stream, resume and regret_validation: no autotune miss or
measurement either; each part checks its launches by shape), again for the
extensions path (the extensions phase: no miss or measurement, launches by
shape), again for the serve path (lm_prefill, lm_serve and
lm_families) and again for the train path (train after its kernel
checks); the sortscan kernels' main-
path launches by packed shape must be those of MAIN_LAUNCHES_BY_SHAPE. The
line before the last lists every kernel with its launches on each path
and their sum, its error and its times (flash attention as two kernels,
bf16 and float32, behind one wrapper; its backward as the three kernels of
one call, counted by dtype); the last line is {"ok": true,
"device": {...}}, printed only after every check passed, and the exit code
is then 0. A failed check raises and the exit code is 1; no CUDA device
exits 2, and a directory without src/repro_torch beside the script exits
3, with no result printed. Needs no network; imports nothing of JAX or of
the reference package ``repro``.
"""
from __future__ import annotations

import base64
import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

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
# SASS opcodes reported for the sortscan and bisect kernels, beside their
# total: barriers, shared and local memory (none may appear at L <= 256)
# and the shuffles that replace them
SASS_OPS = ("BAR", "LDS", "STS", "LDL", "STL", "SHFL")
# bisect kernel instantiations of rows of L <= 256, (W, Q) = (16, 1),
# (32, 1), (32, 2), (32, 4), (32, 8) for the fused step and the projection
# in float32 and bf16; and of the wide rows, (512, Q) for Q = 1, 2, 4, 8
BISECT_INSTANTIATIONS = 15
BISECT_WIDE_INSTANTIATIONS = 12
# proj_bisect against the emulation of its sums' order, bit for bit: the
# widths of tests/test_torch_bisect_layout.py, 333 rows each (on a few rows
# in a hundred another order of the sums changes the bits)
BISECT_NETWORK_LS = (1, 2, 7, 10, 16, 17, 33, 100, 256, 257, 1000, 4096)
BISECT_NETWORK_ROWS = 333
# sortscan kernel instantiations in registers: (16, 2) and (32, E) for
# E = 2 .. 16, fused and standalone; and the two one-block-a-row kernels of
# the wide rows, which use shared memory and barriers by design
SORTSCAN_INSTANTIATIONS = 10
SORTSCAN_WIDE_KERNELS = ("oga_step_sortscan_wide_kernel", "proj_sortscan_wide_kernel")
# the wide rows the kernels phase holds, 96 rows each, 16 of them against
# the float64 oracle (its Python loop takes ~0.2 s a row at L = 4096);
# every 7th row (from row 1) has zero capacity, every 7th (from row 2) z = 0
WIDE_LS = (257, 300, 512, 1000, 4096)
WIDE_ROWS = 96
WIDE_ORACLE_ROWS = 16
# main-path launches of each sortscan kernel by packed shape: fig2's 2000
# slots, the slot profile's 2 x 100 and regret's 2000 at (768, 10), with the
# grid's two single-config rows of 200; the grid's 200 steps in each of 4
# runs at (49152, 10); fig5's 300 at (6144, 100); the regret oracle's 2000
# projections at (768, 10)
MAIN_LAUNCHES_BY_SHAPE = {
    "oga_step_fused": {"768x10": 4600, "49152x10": 800, "6144x100": 300},
    "proj_sortscan": {"768x10": 2000},
}

# Special-function results per clock per SM on Hopper (ex2, rcp): the bf16
# flash kernel's softmax floor on those units. It issues one ex2 per
# unmasked (query, key) pair. Its softcap is tanhf, accurate to float32,
# which costs one ex2 and one rcp more only where |s| hd^-0.5 / softcap
# reaches TANH_POLY_LIMIT; below it the kernel takes tanhf's polynomial on
# the FMA pipe. The floor counts those pairs in this run's data.
SFU_PER_CLOCK_PER_SM = 16
TANH_POLY_LIMIT = 0.6
# Flash kernels against their plain version. float32 (the scalar kernel):
# the reference's bar (tests/test_kernels.py), 2e-5, at the small shapes and
# at the path shape (scores summed in another order). bf16 (the tensor-core
# kernel): the plain version computes p in float32; the kernel rounds P
# once to bf16 before the PV product, as every tensor-core flash kernel and
# SDPA do. V is exact in bf16, the sums are float32, so the rounding
# (relative error <= 2^-9 per p) moves o_d by at most
# 2^-9 sum_j p_j |v_jd| / l = 2^-9 |o|_abs,d, where |o|_abs is the plain
# version run on |v|. Doubled for margin, 2^-8 |o|_abs. Beside it, the
# output's own rounding (both round once; a flip is one ulp <= 2^-7 |o|,
# two ulps 2^-6 |o|) and 1e-4 for outputs near 0 (float32 sums in another
# order); never above the reference's bf16 bar 0.05. So
# min(0.05, 1e-4 + 2^-6 |o| + 2^-8 |o|_abs), elementwise. The term in
# |o|_abs matters where few keys make o cancel towards 0 (the first rows).
# At the path shape |o|_abs is ~0.8 (the mean |v|), so the bar is ~3.5e-3,
# still below the ~1e-2 of a K/V tile dropped at the window's edge.
# The worst element is printed against this bar and against the bar
# without that term. FLASH_BF16_ATOL stays the bar of the SDPA comparison,
# which rounds its probabilities to bf16 too.
FLASH_F32_ATOL = 2e-5
FLASH_BF16_ATOL = 0.05
# float32 SDPA against the float32 kernel without the softcap: SDPA's
# float32 backends may round their products to TF32 (10 mantissa bits), so
# this is the bf16 comparison's bar, a check for a dropped tile, not the
# kernel's bar (the plain version holds it to FLASH_F32_ATOL).
FLASH_F32_SDPA_ATOL = FLASH_BF16_ATOL
FLASH_BF16_RTOL = 2.0 ** -6
FLASH_BF16_NEAR0 = 1e-4
FLASH_BF16_PROB = 2.0 ** -8
FLASH_TIMING_REPS = 10
# The row log-sum-exp both forward kernels write (return_lse) against the
# plain version's: 1e-5 relative, absolute where |lse| < 1 (scores summed
# in float32 in another order, p by ex2.approx: readings 1.3e-7 to 4.4e-7
# on an NVIDIA H100 80GB HBM3); o with the lse written must be o without it, bit for
# bit (serving writes none).
FLASH_LSE_RTOL = 1e-5
# The flash phase's small cases, (B, S, H, G, hd), window, softcap, in both
# dtypes: the reference tests' shapes, hd 80, windows, softcaps, S = 1, S
# around one 128-row tile, a ragged 8191, and the head dims 16, 48 and 112
# (GQA rep 1 to 8) with and without a window and a softcap, one ragged.
FLASH_SMALL_CASES = [
    ((1, 128, 4, 2, 64), None, None), ((2, 256, 4, 1, 64), None, None),
    ((1, 256, 8, 8, 128), None, None), ((2, 512, 2, 1, 64), None, None),
    ((1, 256, 4, 2, 80), None, None), ((1, 256, 4, 2, 64), 128, None),
    ((1, 256, 4, 2, 64), None, 30.0), ((1, 256, 4, 2, 64), 128, 50.0),
    ((1, 191, 4, 2, 128), 64, 50.0), ((3, 1, 8, 1, 64), None, 50.0),
    ((1, 127, 4, 4, 128), None, None), ((1, 128, 4, 2, 128), 200, None),
    ((2, 129, 16, 2, 128), 16, 50.0), ((1, 8191, 4, 2, 80), 4096, 50.0),
    ((1, 256, 4, 2, 16), None, None), ((1, 256, 4, 2, 16), 16, 50.0),
    ((2, 256, 6, 3, 48), None, 50.0), ((1, 256, 6, 1, 48), 64, None),
    ((1, 256, 8, 1, 112), None, None), ((1, 256, 8, 1, 112), 100, 50.0),
    ((2, 333, 8, 2, 112), 128, 50.0), ((1, 1000, 12, 4, 16), 16, 50.0),
    ((1, 1500, 25, 5, 64), 1024, None), ((1, 640, 28, 4, 128), None, None),
    ((2, 333, 25, 5, 64), 100, 50.0),
]
# The full-width prefill shapes of lm_families, one 4096-token prompt, in
# bf16: (B, S, H, G, hd), window. None of these configs softcaps, so one
# SDPA call computes the same function (hymba's window as a boolean mask).
FAMILY_FLASH_SHAPES = {
    "dbrx-132b": ((1, 4096, 48, 8, 128), 0),
    "kimi-k2-1t-a32b": ((1, 4096, 64, 8, 112), 0),
    "hymba-1.5b": ((1, 4096, 25, 5, 64), 1024),
    "qwen2-vl-7b": ((1, 4096, 28, 4, 128), 0),
    "musicgen-medium": ((1, 4096, 24, 24, 64), 0),
}
# gemma2-27b's prefill shape: one 8192-token prompt (the model's context,
# where the 4096 window bites on the local layers), 32 query heads over
# 16 KV heads of 128.
LM_ARCH = "gemma2-27b"
LM_SEQ = 8192
LM_SEED = 20261017
# Decode after prefill(S - 1) against prefill(S)'s last logits. float32,
# 2 layers: the reference's own bar (tests/test_arch_smoke.py). bf16, 46
# layers: every matmul rounds its output to bf16 (8 bits of mantissa) and
# the two paths round different partial sums (M = 8191 against M = 1
# rows), so the residual stream drifts by bf16 ulps over 46 layers; logits
# are ~N(0, 2), capped at 30. That drift measured 0.27 on this seed's
# prompt with the kernel in prefill, 0.23 with the plain attention in its
# place, and 0.31 between the two prefills: it is bf16's, not the kernel's
# (the float32 check sits at ~2e-5). The engine's first-step logits sit
# 0.34-0.45 from prefill's (lm_serve). The bar, 0.7, is 1.5 times the
# largest of those readings (0.454); the argmax must agree. The same bar
# holds the kernel's prefill against the plain attention's, and lm_serve.
LM_F32_DECODE_ATOL = 5e-3
# reduced_lm: the CPU tests' bar (tests/test_torch_lm.py) on the logits and
# the cache of a prefill of 2 x 96 tokens, card against CPU
REDUCED_ARCHS = ("gemma2-27b", "stablelm-3b")
REDUCED_TOKENS = (2, 96)
# the other families' reduced configs (vlm: 8 patch embeddings before the
# 96 tokens), prefilled and then decoded REDUCED_DECODE_STEPS tokens, card
# against CPU at REDUCED_LOGIT_ATOL; 96 is a multiple of their ssm_chunk 16
REDUCED_FAMILY_ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b",
                        "qwen2-vl-7b", "musicgen-medium")
REDUCED_DECODE_STEPS = 8
REDUCED_LOGIT_ATOL = 1e-4
LM_BF16_DECODE_ATOL = 0.7
LM_PREFILL_REPS = 2
# The int8 KV cache (kv_cache_quant=True). reduced_lm: reduced(stablelm-3b)
# prefilled (2 x 96 tokens) and decoded REDUCED_INT8_STEPS tokens on the
# card and on the CPU. The prefill's logits do not read the cache:
# REDUCED_LOGIT_ATOL. K and V differ by float32 rounding between the
# devices, so a value on a rounding boundary may take the next int8 code:
# codes may differ by at most 1, scales (max|K| / 127) by at most
# REDUCED_LOGIT_ATOL / 127, and the decode's logits by REDUCED_LOGIT_ATOL
# plus INT8_FLIP_LOGIT for every code that differs. One code moved by one
# step moves these logits by at most half of INT8_FLIP_LOGIT
# (tests/test_torch_kv_quant.py holds it on the CPU at this config).
REDUCED_INT8_ARCH = "stablelm-3b"
REDUCED_INT8_STEPS = 8
INT8_FLIP_LOGIT = 0.03
# lm_serve: 4 slots, a 512-slot cache, 8 greedy requests of 32-64 prompt
# tokens and 32 new ones. The logits of the step that gives a request its
# first token are held to the bf16 decode bar above against prefill's, and
# the token to the argmax of those logits. The token must equal prefill's
# argmax unless prefill's top-2 gap is at most SERVE_TIE_GAP, twice the
# logit bar: past that gap no two logit vectors within the bar can disagree,
# so this rule follows from the logit bar and adds no check of its own.
# Random weights give gaps of 0.03-0.45, so at this seed it exempts every
# request; the agreement is printed (first_tokens_equal_prefill_argmax).
SERVE_SLOTS = 4
SERVE_CACHE_LEN = 512
SERVE_REQUESTS = 8
SERVE_NEW_TOKENS = 32
SERVE_TIE_GAP = 2 * LM_BF16_DECODE_ATOL
# lm_families: the other six configs at full width, in bf16, depth cut only
# where the card forces it (None: every layer). dbrx-132b's layer is 6.5 GB
# in bf16: 8 layers and the embeddings are 54.6 GB, and the init draws each
# (16, 6144, 10752) expert tensor in float32 (4.2 GB) beside them; 10
# would leave no room for that and the prefill. kimi-k2-1t-a32b's layer is
# 34.2 GB: 1 layer and the embeddings are 38.8 GB, and its (384, 7168,
# 2048) expert tensors are drawn in float32 (22.5 GB) beside them.
FAMILY_LAYERS = {"musicgen-medium": None, "qwen2-vl-7b": None, "mamba2-780m": None,
                 "hymba-1.5b": None, "dbrx-132b": 8, "kimi-k2-1t-a32b": 1}
FAMILY_SEQ = 4096
# MoE decode runs at capacity_factor = E / k (C = T: no assignment can
# drop, as reduced() raises the factor to 8.0 for its tests) on a prompt of
# MOE_DECODE_SEQ tokens; SSM and hybrid decode SSM_DECODE_STEPS teacher-
# forced steps after prefill(FAMILY_SEQ - SSM_DECODE_STEPS), each against
# forward(FAMILY_SEQ) at its position (S - 1 is no legal SSD length)
MOE_DECODE_SEQ = 256
SSM_DECODE_STEPS = 256
# the first SSM_F32_SSD_STEPS of those steps again with prefill's and
# forward's chunked SSD in float32, held at LM_BF16_DECODE_ATOL: what the
# reference's bf16 SSD costs (FAMILY_BF16_ATOL) is not the decode path's
SSM_F32_SSD_STEPS = 32
SSM_F32_SSD_ATOL = 2.1  # 1.5 times mamba2's 1.37 (FAMILY_BF16_ATOL's comment)
# the float32 check's depth (all but kimi, whose 2 float32 layers do not fit)
FAMILY_F32_LAYERS = 2
# apply_moe against _local_dispatch_combine(..., 0, E, E) plus the shared
# expert at the first layer's MoE input, at the published factor: float32
# outputs within this share of max |out| (sums in another order), the kept
# (token, expert) pairs equal exactly
MOE_ORACLE_RTOL = 1e-5
# the bf16 bar of lm_families' decode checks and of its Engine, by config:
# LM_BF16_DECODE_ATOL where the readings fit under it (NVIDIA H100 80GB
# HBM3, 700 W: musicgen 0.25, qwen2-vl 0.34, dbrx 0.17, kimi 0.055; the
# Engine's reused slots equal fresh ones exactly). mamba2 and hymba:
# the reference's SSD runs in bf16 in a bf16 config (dt A cast down, its
# cumulative sum over a 256-token chunk reaching thousands where bf16's
# spacing is 16: ROADMAP Queue 3, item 11, tests/_ssd_bf16_drift.py), so
# forward(S) and 256 decode steps after prefill(S - 256) read 9.94 and
# 9.16 apart; with that SSD in float32 the first 32 of the same steps read
# 1.37 and 0.93 (SSM_F32_SSD_ATOL), and at float32 throughout (2 layers)
# 3.4e-4 and 3.9e-4. Each bar is 1.5 times its config's reading.
FAMILY_BF16_ATOL = {**{arch: LM_BF16_DECODE_ATOL for arch in FAMILY_LAYERS},
                    "mamba2-780m": 14.9, "hymba-1.5b": 13.7}
# The Engine's first-token logits against prefill's (musicgen and the MoE
# configs). dbrx-132b's eight requests read 0.16-0.84 and, apart, 1.30 and
# 2.22 (the same in two runs); kimi's 0.047 seven times and 0.48 once;
# musicgen's 0.23-0.35. The
# Engine feeds a prompt of 16-32 tokens through decode one token at a
# time, and over 8 layers of top-4 of 16 experts a near tie between two
# experts' router scores can fall one way on prefill's bf16 hidden states
# and the other on decode's, moving that token's output by a whole expert:
# a jump, which the outliers look like (the one-step decode against
# prefill, one token routed, reads 0.17). The bar is 1.5 times dbrx's 2.22.
FAMILY_ENGINE_PREFILL_ATOL = {**FAMILY_BF16_ATOL, "dbrx-132b": 3.4}
# the Engine: 8 greedy requests of 16-32 prompt tokens and 16 new over 4
# slots, cache 128, so that 4 requests reuse a slot; each against the same
# request alone in a fresh Engine of 4 slots
FAMILY_SERVE_SLOTS = 4
FAMILY_SERVE_CACHE_LEN = 128
FAMILY_SERVE_REQUESTS = 8
FAMILY_SERVE_PROMPT = (16, 32)
FAMILY_SERVE_NEW_TOKENS = 16

# Phase train: the training slice (ROADMAP Queue 1, item 15g). The flash
# backward kernels against their plain version at these shapes (the last
# three also timed: stablelm-3b's training shape and gemma2-27b's global
# layer, with and without its 4096 window), in float32 and bf16, fed the
# lse of the forward kernel of their dtype. Bars: float32, each of dq, dk,
# dv within BWD_F32_RTOL_OF_MAX of its largest magnitude of the plain
# version (both add in float32, in other orders; readings 0.004 to 0.061 of
# the bar on an NVIDIA H100 80GB HBM3); bf16, the kernel's distance from the emulation of
# its arithmetic (ref.flash_attention_bwd_emulation: P^T and dS^T rounded
# once to bf16 before the products, as the tensor-core kernels do) at most
# BWD_BF16_EMU_ULPS bf16 ulps of the largest magnitude of the float32
# gradient. The two differ by the order of float32 sums, so by roundings
# that flip: an output's, at most one ulp of the largest element, and a P
# or dS entry's, which moves one term of a sum by one ulp of that entry
# (<= 2^-8 |dO| or |Q| for p in [0.5, 1)); the second ulp covers those.
# The train slice's per-leaf bar is the plain version's: the kernels'
# distance from the float32 plain gradient of the same (upcast) inputs at
# most BWD_BF16_PLAIN_FACTOR times the bf16 plain version's (the output
# rounding alone) plus BWD_BF16_RTOL_OF_MAX of the largest magnitude. The
# kernels here are not held to it: with P^T and dS^T rounded, the
# emulation itself exceeds it at small shapes (PERF.md section 6, read by
# python tests/test_torch_flash_bwd_numerics.py). Two launches bit for
# bit (no atomics).
BWD_SMALL_CASES = [
    ((2, 96, 4, 2, 16), 0, None),
    ((1, 256, 4, 1, 16), 16, 50.0),
    ((1, 1000, 8, 2, 64), 0, None),     # a ragged S
    ((2, 512, 8, 8, 80), 0, None),
    ((1, 1024, 28, 4, 128), 0, None),   # GQA rep 7
    ((1, 4096, 25, 5, 64), 1024, None),  # hymba-1.5b's
    ((1, 4096, 16, 8, 112), 0, None),
    ((1, 1024, 8, 4, 80), 256, 50.0),   # hd 80 with a window and the softcap
]
BWD_PATH_SHAPES = {
    "stablelm-3b": ((4, 4096, 32, 32, 80), 0, None),
    "gemma2-27b": ((1, 8192, 32, 16, 128), 0, 50.0),
    "gemma2-27b_window4096": ((1, 8192, 32, 16, 128), 4096, 50.0),
}
BWD_F32_RTOL_OF_MAX = 1e-4
BWD_BF16_PLAIN_FACTOR = 2.0
BWD_BF16_RTOL_OF_MAX = 1e-3
BWD_BF16_EMU_ULPS = 2
BWD_TIMING_REPS = 5
# the plain gradient takes 120-200 ms a call at the path shapes
BWD_PLAIN_TIMING_REPS = 2
# the gradient's products the kernels run: seven, the function's five
# (roofline.BWD_PRODUCTS) with QK^T and dO V^T once for dK/dV and once for
# dQ (no atomics)
KERNEL_BWD_PRODUCTS = 7
# The slice: stablelm-3b at full width. First 2 of its 32 layers, float32
# params and compute, on one row of 4096 tokens of batch_at(step 0): loss
# and backward through the kernels against the same through the plain
# attention pair (loss within TRAIN_LOSS_RTOL, every gradient leaf within
# TRAIN_GRAD_RTOL_OF_MAX of its largest magnitude: the kernels' float32
# differences from the plain pair, ~1e-6, carried through two layers), and
# the same in bf16 under the bf16 rule above, per leaf. Then all 32 layers
# in bf16 through launch/train.py's build: TRAIN_BATCH x TRAIN_SEQ tokens
# (train_4k's sequence, 4 of its 256 sequences), the CLI's lr and warm-up,
# TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS steps, a fresh checkpoint
# directory and no checkpoint written; each step 2 x 32 forward launches
# (forward, remat recompute) and 32 backward calls; peak below the card.
TRAIN_ARCH = "stablelm-3b"
TRAIN_SLICE_LAYERS = 2
TRAIN_SLICE_TOKENS = 4096
TRAIN_BATCH = 4
TRAIN_SEQ = 4096
TRAIN_WARMUP_STEPS = 1
TRAIN_TIMED_STEPS = 3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL_OF_MAX = 1e-4
TRAIN_PEAK_BYTES = 80e9
# launch/dryrun.py on meta tensors, on a 1-position mesh, against the card:
# the Trainer's configuration (phase train) and gemma2-27b's 8192-token
# prefill (phase lm_prefill). The argument bytes of the parameters (and
# the optimizer state) equal the bytes held on the card exactly; the
# predicted peak (arguments + temporaries) over the measured peak lies
# within the bar. The meta run frees what the card's eager run frees, at
# the same points, so the ratio stays at or below 1 (0.01 of slack); the
# card adds what meta tensors cannot show (library workspaces, the
# allocator's rounding, the init's float32 draws, the int64 batch):
# 1.13 and 0.99 GB, ratios 0.974 and 0.984, in the first reading
# (PERF.md section 2), and the bar leaves twice that gap. §3.2's cell at
# the extensions phase's 4 shards: per-position argument bytes equal the
# shard's tensors.
DRYRUN_PEAK_RATIO_BARS = {"train": (0.95, 1.01), "lm_prefill": (0.95, 1.01)}
# the seconds the dry-run predictions and the compile counter may add
ADDED_PARTS_BUDGET_S = 10.0
# the seconds each of those parts took, filled in as they run
ADDED_SECONDS: dict = {}
# the lint phase reads about 90 files; it must stay a small share of the run
LINT_SECONDS_BAR = 5.0
# every family's reduced config (float32, head dim 16), one train step on
# the card against the CPU (the bars above); the Trainer's restart on the
# card (reduced stablelm-3b, 8 steps, checkpoints every 4, a failure
# injected at step 5, then resumed: the last 3 losses and every state leaf
# bit for bit an uninterrupted run's); 25 steps with compressed gradients
# (tests/test_substrate.py:143: the last 5 losses' mean below the first 5's)
TRAIN_REDUCED_ARCHS = ("stablelm-3b", "gemma2-27b", "qwen2-72b", "starcoder2-15b",
                       "dbrx-132b", "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b",
                       "qwen2-vl-7b", "musicgen-medium")
TRAIN_REDUCED_TOKENS = (2, 32)
TRAIN_RESTART_STEPS = 8
TRAIN_RESTART_EVERY = 4
TRAIN_RESTART_FAIL_AT = 5
TRAIN_COMPRESS_STEPS = 25
# Phase train, part "mesh": the multi-device modules on one card, on the
# parameters stablelm-3b just trained (its optimizer moments freed).
# (a) models.pipeline at full depth in bf16: MESH_PIPE_STAGES stages of 8
# layers on ["cuda"] * 4, MESH_PIPE_MICRO microbatches of MESH_PIPE_TOKENS:
# the forward bit for bit stack_forward over the same microbatches (the
# same kernels on the same shapes in the same order; its distance from the
# whole batch's stack_forward recorded, cuBLAS meeting other row counts
# there), every gradient leaf within MESH_PIPE_BF16_ULPS bf16 ulps of its
# largest magnitude of the microbatched reference's (the same terms summed
# in another order), wq / wk / wv of every layer non-zero, and exactly
# 32 x 4 forward calls, 32 x 4 backward calls and 32 x 4 x 3 backward
# kernels; (b) the first MESH_PIPE_F32_LAYERS layers cast to float32, 4
# stages, MESH_PIPE_F32_MICRO microbatches of MESH_PIPE_F32_TOKENS against
# stack_forward over the whole batch (output MESH_F32_RTOL_OF_MAX, each
# gradient leaf TRAIN_GRAD_RTOL_OF_MAX of its largest magnitude: phase
# train's CPU bars); (c) moe.apply_mlp_ep at tp MESH_MLP_TP on a float32
# copy of layer 0's MLP (d_ff 6912: 1728 a shard), 1 x MESH_MLP_TOKENS,
# against swiglu_apply (MESH_F32_RTOL_OF_MAX of the largest magnitude);
# (d) launch.elastic: the reduced config's parameters placed on a
# MESH_RESHARD_FROM mesh of the card, checkpointed, and rescaled onto
# MESH_RESHARD_TO: every leaf bit for bit after a gather, every shard of
# the shape its sharding gives and on the card.
MESH_PIPE_STAGES = 4
MESH_PIPE_MICRO = 4
MESH_PIPE_TOKENS = (4, 1024)
MESH_PIPE_BF16_ULPS = 2
MESH_PIPE_F32_LAYERS = 4
MESH_PIPE_F32_MICRO = 2
MESH_PIPE_F32_TOKENS = (2, 1024)
MESH_F32_RTOL_OF_MAX = 1e-5
MESH_MLP_TP = 4
MESH_MLP_TOKENS = 4096
MESH_RESHARD_FROM = (8, 1)
MESH_RESHARD_TO = (2, 4)
MESH_TIMING_REPS = 3
# lm_families: apply_moe_ep on the first layer's 4096 tokens at the
# published capacity factor (1.25) over a (data 1, model tp) mesh of the
# card, against apply_moe: kept (token, expert) pairs equal, float32 within
# MOE_ORACLE_RTOL of max |out| (dbrx; kimi's float32 experts do not fit
# beside its bf16 ones), bf16 recorded
MOE_EP_MESHES = {"dbrx-132b": (1, 4), "kimi-k2-1t-a32b": (1, 8)}

# The job lifecycle at benchmarks/bench_lifecycle.py:27 (the paper's
# evaluation scale, work_mean 1200: jobs hold resources for many slots and
# queues form) with T cut from 2000 to 1000 (the six policies' host time,
# ~67 ms a slot together, made room for the stream path; the card's
# events equalled the reference's over all 2000 slots), and the fault
# regimes of benchmarks/bench_faults.py:35 at its quick configuration
# (bench_faults.py:55) with T cut from 1500 to 500 (heSRPT's 24
# projections a slot cost ~20 ms of host time each slot).
LIFECYCLE_CFG = dict(T=1000, L=10, R=128, K=6, seed=0, work_mean=1200.0)
LIFECYCLE_ALGORITHMS = ("ogasched", "drf", "fairness", "binpacking", "spreading", "multiclass")
FAULTS_CFG = dict(T=500, L=10, R=64, K=6, seed=0, work_mean=600.0)
FAULTS_ALGORITHMS = ("ogasched", "drf", "fairness", "binpacking", "spreading", "hesrpt")
# seconds a faults worker (one regime, six runs) may take
FAULTS_WORKER_TIMEOUT_S = 600
FAULT_REGIMES = {
    "none": {},
    "failures": dict(fail_rate=0.02, fail_frac=0.3, repair_mean=40.0),
    "drains": dict(drain_period=200, drain_len=40, drain_frac=0.5),
    "shocks": dict(shock_rate=0.01, shock_depth=0.5),
}
# The reference's admitted / departed records of both phases (packed bits),
# written with the pins below by tests/_lifecycle_pins.py.
LIFECYCLE_EVENTS = os.path.join("tools", "lifecycle_reference_events.json")
# Readings of the JAX reference package on the CPU (jax 0.9.0) at the
# lifecycle and faults phases' configurations, OGASCHED started from the
# port's y0 (sched/lifecycle.py default_y0), made with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_lifecycle_pins.py
# which also writes LIFECYCLE_EVENTS.
NAN = float("nan")
LIFECYCLE_REFERENCE = {
    'ogasched': {'completed': 3517.0, 'arrived': 3586.0, 'dropped': 3199.0, 'throughput': 3.517, 'goodput': 4419.375, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'jct_mean': 19.719648361206055, 'jct_p99': 71.0, 'slowdown_mean': 7.6343865394592285, 'utilization': 0.6052642464637756, 'utilization/0': 0.4315599799156189, 'utilization/1': 0.45028117299079895, 'utilization/2': 0.7160739302635193, 'utilization/3': 0.6727064251899719, 'utilization/4': 0.6894002556800842, 'utilization/5': 0.6715636253356934, 'avg_reward': 3359.12060546875},
    'drf': {'completed': 3383.0, 'arrived': 3453.0, 'dropped': 3332.0, 'throughput': 3.383, 'goodput': 4083.37375, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'jct_mean': 20.32367706298828, 'jct_p99': 115.0, 'slowdown_mean': 7.470068454742432, 'utilization': 0.7171883583068848, 'utilization/0': 0.4377756416797638, 'utilization/1': 0.6794133186340332, 'utilization/2': 0.8674949407577515, 'utilization/3': 0.770229697227478, 'utilization/4': 0.757182240486145, 'utilization/5': 0.7910342812538147, 'avg_reward': 3059.02001953125},
    'fairness': {'completed': 3508.0, 'arrived': 3581.0, 'dropped': 3204.0, 'throughput': 3.508, 'goodput': 4182.2975, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'jct_mean': 19.801311492919922, 'jct_p99': 124.929931640625, 'slowdown_mean': 7.428719520568848, 'utilization': 0.7147977352142334, 'utilization/0': 0.4404500424861908, 'utilization/1': 0.6783817410469055, 'utilization/2': 0.8680346608161926, 'utilization/3': 0.7700400948524475, 'utilization/4': 0.7572470307350159, 'utilization/5': 0.7746330499649048, 'avg_reward': 3259.21435546875},
    'binpacking': {'completed': 3371.0, 'arrived': 3445.0, 'dropped': 3340.0, 'throughput': 3.371, 'goodput': 4046.20475, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'jct_mean': 20.66834831237793, 'jct_p99': 140.0, 'slowdown_mean': 7.535602569580078, 'utilization': 0.7150897979736328, 'utilization/0': 0.4321938753128052, 'utilization/1': 0.6772639751434326, 'utilization/2': 0.8669192790985107, 'utilization/3': 0.7702471017837524, 'utilization/4': 0.7549005746841431, 'utilization/5': 0.7890138030052185, 'avg_reward': 2998.41455078125},
    'spreading': {'completed': 3389.0, 'arrived': 3462.0, 'dropped': 3323.0, 'throughput': 3.389, 'goodput': 4043.67275, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'jct_mean': 20.676010131835938, 'jct_p99': 137.0, 'slowdown_mean': 7.524747848510742, 'utilization': 0.7148588299751282, 'utilization/0': 0.4308435022830963, 'utilization/1': 0.6779658794403076, 'utilization/2': 0.8668879866600037, 'utilization/3': 0.7702662944793701, 'utilization/4': 0.75505530834198, 'utilization/5': 0.7881340980529785, 'avg_reward': 3031.183837890625},
    'multiclass': {'completed': 3842.0, 'arrived': 3908.0, 'dropped': 2877.0, 'throughput': 3.842, 'goodput': 4597.856, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'jct_mean': 17.6595516204834, 'jct_p99': 65.0, 'slowdown_mean': 7.381320953369141, 'utilization': 0.6744717955589294, 'utilization/0': 0.4378211200237274, 'utilization/1': 0.4399919807910919, 'utilization/2': 0.8636510968208313, 'utilization/3': 0.765095055103302, 'utilization/4': 0.7522012591362, 'utilization/5': 0.7880700826644897, 'avg_reward': 3641.5322265625},
}
FAULTS_REFERENCE = {
    'none': {
        'ogasched': {'goodput': 2316.0655, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1943.0, 'recovery_time': 0.0},
        'drf': {'goodput': 2123.25325, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1780.0, 'recovery_time': 0.0},
        'fairness': {'goodput': 2216.987, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1676.0, 'recovery_time': 0.0},
        'binpacking': {'goodput': 2082.7045, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1776.0, 'recovery_time': 0.0},
        'spreading': {'goodput': 2088.644875, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1767.0, 'recovery_time': 0.0},
        'hesrpt': {'goodput': 2425.764, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1892.0, 'recovery_time': 0.0},
    },
    'failures': {
        'ogasched': {'goodput': 2095.17234375, 'wasted_work': 53413.578125, 'evictions': 223.0, 'fault_drops': 70.0, 'completed': 1860.0, 'recovery_time': 0.0},
        'drf': {'goodput': 1980.1694140625, 'wasted_work': 50593.41796875, 'evictions': 256.0, 'fault_drops': 97.0, 'completed': 1769.0, 'recovery_time': 0.0},
        'fairness': {'goodput': 2044.966734375, 'wasted_work': 49877.8828125, 'evictions': 260.0, 'fault_drops': 79.0, 'completed': 1829.0, 'recovery_time': 0.0},
        'binpacking': {'goodput': 1950.373765625, 'wasted_work': 57559.8671875, 'evictions': 254.0, 'fault_drops': 95.0, 'completed': 1770.0, 'recovery_time': 0.0},
        'spreading': {'goodput': 1959.34178125, 'wasted_work': 56602.796875, 'evictions': 259.0, 'fault_drops': 92.0, 'completed': 1769.0, 'recovery_time': 0.0},
        'hesrpt': {'goodput': 2309.342, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1792.0, 'recovery_time': 0.0},
    },
    'drains': {
        'ogasched': {'goodput': 2207.2044765625, 'wasted_work': 21120.51171875, 'evictions': 43.0, 'fault_drops': 12.0, 'completed': 1877.0, 'recovery_time': NAN},
        'drf': {'goodput': 2028.5416953125, 'wasted_work': 19564.65234375, 'evictions': 52.0, 'fault_drops': 26.0, 'completed': 1766.0, 'recovery_time': NAN},
        'fairness': {'goodput': 2070.05908203125, 'wasted_work': 29064.708984375, 'evictions': 46.0, 'fault_drops': 20.0, 'completed': 1808.0, 'recovery_time': NAN},
        'binpacking': {'goodput': 2025.89990625, 'wasted_work': 18452.359375, 'evictions': 58.0, 'fault_drops': 23.0, 'completed': 1743.0, 'recovery_time': NAN},
        'spreading': {'goodput': 1990.041484375, 'wasted_work': 37462.1953125, 'evictions': 60.0, 'fault_drops': 25.0, 'completed': 1704.0, 'recovery_time': NAN},
        'hesrpt': {'goodput': 2316.6835, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1972.0, 'recovery_time': NAN},
    },
    'shocks': {
        'ogasched': {'goodput': 2199.4804453125, 'wasted_work': 29903.90234375, 'evictions': 101.0, 'fault_drops': 29.0, 'completed': 1954.0, 'recovery_time': 0.0},
        'drf': {'goodput': 2010.708453125, 'wasted_work': 32759.3984375, 'evictions': 106.0, 'fault_drops': 50.0, 'completed': 1780.0, 'recovery_time': 0.0},
        'fairness': {'goodput': 2030.093765625, 'wasted_work': 51859.3671875, 'evictions': 123.0, 'fault_drops': 44.0, 'completed': 1804.0, 'recovery_time': 0.0},
        'binpacking': {'goodput': 1988.776984375, 'wasted_work': 34503.4453125, 'evictions': 121.0, 'fault_drops': 48.0, 'completed': 1759.0, 'recovery_time': 0.0},
        'spreading': {'goodput': 2009.18621484375, 'wasted_work': 25624.330078125, 'evictions': 129.0, 'fault_drops': 41.0, 'completed': 1772.0, 'recovery_time': 0.0},
        'hesrpt': {'goodput': 2384.95275, 'wasted_work': 0.0, 'evictions': 0.0, 'fault_drops': 0.0, 'completed': 1848.0, 'recovery_time': 0.0},
    },
}
# Bars of the lifecycle and faults phases against those readings (PERF.md
# section 2), on the error |card - reference| / max(|reference|, 1). While
# the card's admitted / departed record equals the reference's, the runs
# differ only by float32 sums in another order and the card's projection
# solved in double: REWARD_RTOL holds every metric. Once the record leaves
# the reference's (a rounding flips a threshold: a departure, a node
# ranking), they are two sample paths of one system, and DRIFT_BARS hold
# each metric at twice the largest error the reference's own readings show
# when its capacities or job sizes move by one float32 ulp
# (tests/_lifecycle_pins.py --sensitivity).
# The reference drifts so only for SPREADING, at the faults phase's
# failures, drains and shocks regimes; "*" covers utilization and
# utilization/<k>, and recovery_time, which never moved, keeps REWARD_RTOL.
DRIFT_BARS = {"*": 0.003, "arrived": 0.043, "avg_reward": 0.025, "completed": 0.045,
              "dropped": 0.048, "evictions": 0.067, "fault_drops": 0.305, "goodput": 0.016,
              "jct_mean": 0.044, "jct_p99": 0.174, "slowdown_mean": 0.041, "throughput": 0.045,
              "wasted_work": 0.536, "recovery_time": REWARD_RTOL}
# grid_lifecycle: 8 of the grid phase's 64 Fig. 2 configs at T 200, faults
# off and under the "failures" regime, against run_all of each config; the
# kernels' path (OGASCHED: one fused and one projection launch at (6144, 10)
# a slot; FAIRNESS: the projection). heSRPT's batched grid is held to the
# looped run_all on the CPU (tests/test_torch_sweep.py): its 16 reference
# runs here would cost ~140 s of host time.
GRID_LIFECYCLE_CONFIGS = 8
GRID_LIFECYCLE_T = 200
GRID_LIFECYCLE_ALGORITHMS = ("ogasched", "fairness")
GRID_LIFECYCLE_RTOL = 1e-4
# Steps of the size-aware policies' fluid solve a slot
# (core/baselines.py MULTICLASS_ITERS): one projection launch each.
FLUID_ITERS = 24
# The stream path. stream: benchmarks/bench_sweep.py's configuration
# (CFG and ALGOS, bench_sweep.py:41-42) streamed as its full-scale run does
# (bench_sweep.py:302-305): (a) 10000 slot-mode configs (seeds 0-9999) in
# chunks of 256, "auto" resolving to device traces: one fused launch a
# step at (16384, 6); (b) the lifecycle grid, chunks of 32, device traces,
# over all its 2000 configs (36 s on the card: no cut): a fused and
# a projection launch at (2048, 6) a OGASCHED slot, a projection a
# FAIRNESS slot; (c) host traces: the grid phase's 64 Fig. 2 configs in
# chunks of 16, (12288, 10), held to the grid phase's resident rows;
# (d) device traces of 8 configs on the card against the same call on the
# CPU: the hash words and the spec bit for bit (integer and correctly
# rounded float32 arithmetic only), arrivals in at most
# STREAM_ARRIVAL_FLIPS of their 4800 entries (p passes through sin, ~2 ulp
# apart between the devices), job sizes within STREAM_WORKS_RTOL (pow),
# fault multipliers off by more than 1e-6 in at most STREAM_FAULT_FLIPS of
# their 3200 entries (a repair time passes through log). An H100 read 0
# arrival flips, 0 fault flips and job sizes within 1.18e-7: the flip bars
# allow two entries each, the job-size bar is ~8x its reading.
# The slot stream's peak device memory above its start is held to
# STREAM_PEAK_RATIO x grid_memory_bytes' total at the chunk (an H100 read
# 5.81x: the model leaves out step temporaries and the hash words), so a
# stream that kept chunks alive fails.
STREAM_CFG = dict(T=100, L=6, R=16, K=4)
STREAM_ALGORITHMS = ("ogasched", "fairness")
STREAM_POINTS = 10_000
STREAM_CHUNK = 256
STREAM_LIFECYCLE_POINTS = 2000
STREAM_LIFECYCLE_CHUNK = 32
STREAM_HOST_CHUNK = 16
STREAM_DEVICE_CONFIGS = 8
STREAM_ARRIVAL_FLIPS = 2 / (STREAM_DEVICE_CONFIGS * STREAM_CFG["T"] * STREAM_CFG["L"])
STREAM_WORKS_RTOL = 1e-6
STREAM_FAULT_FLIPS = 2 / (STREAM_DEVICE_CONFIGS * STREAM_CFG["T"] * STREAM_CFG["K"])
STREAM_PEAK_RATIO = 8.0
# slots of a lifecycle chunk the stream phase profiles
STREAM_PROFILE_SLOTS = 25
# resume: the first RESUME_POINTS of those configs, chunks of 256, in a
# subprocess (this script with --resume-worker) killed with SIGKILL once
# RESUME_KILL_AFTER chunks verify (each chunk held RESUME_SLOW_S after its
# reduction so the kill lands mid-sweep), resumed in a fresh process.
RESUME_POINTS = 2048
RESUME_CHUNK = 256
RESUME_KILL_AFTER = 2
RESUME_SLOW_S = 1.0
RESUME_WAIT_S = 300
# regret_validation: benchmarks/bench_regret.py's quick configuration
# (bench_regret.py:28-44): 7 utilities x 2 regimes x seeds 0-3, chunks of
# 16 (fused launches at (1024, 6)), 1500 oracle iterations (one
# proj_sortscan launch each at (1024, 6)), 200 bootstrap resamples.
REGRET_CFG = dict(T=2048, L=6, R=16, K=4, contention=10.0)
REGRET_UTILITIES = ("linear", "log", "reciprocal", "poly", "pow25", "pow75", "expsat")
REGRET_REGIMES = ("stationary", "flash")
REGRET_SEEDS = (0, 1, 2, 3)
REGRET_CHUNK = 16
REGRET_ORACLE_ITERS = 1500
REGRET_N_BOOT = 200
REGRET_PROFILE_SHARE = 16
# The JAX reference's readings of that grid on the CPU (jax 0.9.0), from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_regret_pins.py
REGRET_REFERENCE = {
    "linear/stationary": {"r_T_mean": 23012.80859375, "bound": 387565.01684602106,
        "exponent": 0.07031876867518948, "bound_ok": True, "sublinear": True},
    "linear/flash": {"r_T_mean": 21064.21484375, "bound": 387565.01684602106,
        "exponent": 0.03482313475261777, "bound_ok": True, "sublinear": True},
    "log/stationary": {"r_T_mean": 2178.5087890625, "bound": 387565.01684602106,
        "exponent": 0.14590706781765309, "bound_ok": True, "sublinear": True},
    "log/flash": {"r_T_mean": 1234.268798828125, "bound": 387565.01684602106,
        "exponent": 0.02638283846252868, "bound_ok": True, "sublinear": True},
    "reciprocal/stationary": {"r_T_mean": 72.57005310058594, "bound": 242281.8576902502,
        "exponent": -0.03929442812359507, "bound_ok": True, "sublinear": True},
    "reciprocal/flash": {"r_T_mean": -193.46884155273438, "bound": 242281.8576902502,
        "exponent": -0.5372657583629019, "bound_ok": True, "sublinear": True},
    "poly/stationary": {"r_T_mean": 1854.17919921875, "bound": 202431.81094912573,
        "exponent": 0.1163448518388547, "bound_ok": True, "sublinear": True},
    "poly/flash": {"r_T_mean": 996.6452026367188, "bound": 202431.81094912573,
        "exponent": -0.007658773635872747, "bound_ok": True, "sublinear": True},
    "pow25/stationary": {"r_T_mean": 252.59425354003906, "bound": 116925.32670597862,
        "exponent": 0.24291198446887946, "bound_ok": True, "sublinear": True},
    "pow25/flash": {"r_T_mean": -873.541259765625, "bound": 116925.32670597862,
        "exponent": -1.3935344380142098, "bound_ok": True, "sublinear": True},
    "pow75/stationary": {"r_T_mean": 9467.1572265625, "bound": 294092.37809146085,
        "exponent": 0.1573478571932399, "bound_ok": True, "sublinear": True},
    "pow75/flash": {"r_T_mean": 8536.2421875, "bound": 294092.37809146085,
        "exponent": 0.11635762992329736, "bound_ok": True, "sublinear": True},
    "expsat/stationary": {"r_T_mean": 1139.587890625, "bound": 387565.01684602106,
        "exponent": 0.30305114937435024, "bound_ok": True, "sublinear": True},
    "expsat/flash": {"r_T_mean": 327.77789306640625, "bound": 387565.01684602106,
        "exponent": 0.03039485040014348, "bound_ok": True, "sublinear": True},
}
# Bars against those readings. The port on the CPU reaches, over all 14
# cells (tests/_regret_pins.py --port), |r_T_mean - ref| = 1.9e-5 x the
# bound (log/flash: 7.3 of a regret of 1234, the difference of two
# cumulative rewards of ~4e5), |exponent - ref| = 1.05e-3 and
# |bound - ref| = 4.3e-8 x the bound; each bar is ~5-20x that. The flags
# must be equal.
REGRET_R_T_BAR = 1e-4
REGRET_EXPONENT_ATOL = 0.01
REGRET_BOUND_RTOL = 1e-6
# The extensions path (the paper's §3.2, §3.4 and §3.5, and the job
# manager). (a) §3.4 at Fig. 2's config (paper Tab. 2;
# benchmarks/bench_reward.py:17) with Poisson counts
# (trace.build_arrivals(multi=True)): J = the largest count, one fused
# launch a slot over (R*K, L*J) rows; the J = 1 expansion of Fig. 2's
# indicator trace must give the fig2 phase's OGASCHED rewards bit for bit.
EXT_MULTI_CFG = dict(T=2000, L=10, R=128, K=6, seed=1, contention=10.0)
EXT_ETA0, EXT_DECAY = 25.0, 0.9999
# The average reward is held at REWARD_RTOL. At L*J = 90 ports the
# trajectory amplifies rounding: the reference's own average moves by up
# to 2.18e-4 relative when c, a or alpha moves by one float32 ulp, its
# per-slot rewards parting from the unperturbed run's (by more than
# TRAJ_TOL of the largest) from slot 111 on (tests/_extensions_pins.py
# --sensitivity), and the port's plain path on the CPU reads 2.2e-4. So
# the per-slot rewards are also held to the reference's pinned first
# EXT_MULTI_PREFIX slots, where rounding has not yet been amplified: the
# first slot that parts is recorded and the average of the slots before
# it held at REWARD_RTOL (the CPU tests hold the plain path so).
EXT_MULTI_PREFIX = 100
# (b) §3.5 on the same spec over the first EXT_GANG_T slots of its
# indicator trace: EXT_GANG_Q tasks a job type, requests uniform(0.5, 3.0)
# from EXT_GANG_SEED, the last task absent on even ports, m_l = ceil(valid
# tasks / 2), eta EXT_GANG_ETA fixed, y(1) = 0: one fused launch over
# (R*K, L*Q) rows a slot, then the All-or-Nothing repair.
EXT_GANG_T = 500
EXT_GANG_Q = 4
EXT_GANG_SEED = 20261017
EXT_GANG_ETA = 5.0
# (c) §3.2 at the repo's cluster-scale scheduler cell (launch/dryrun.py:322
# run_sched_cell: L 100, R 131072, K 6, density 0.25, seed 0): y(1) a
# feasible draw from EXT_DIST_Y0_SEED, x(t) from build_arrivals, eta 25,
# EXT_DIST_STEPS steps on 1 and 4 shards of the one card, each step held to
# the unsharded fused step from the same y (the reference's bars,
# tests/test_distributed.py: y 2e-5 absolute, q 1e-5 relative; y bit for
# bit on one shard).
EXT_DIST_CFG = dict(T=10, L=100, R=131072, K=6, seed=0, density=0.25)
EXT_DIST_Y0_SEED = 20261017
EXT_DIST_ETA = 25.0
EXT_DIST_SHARDS = (1, 4)
EXT_DIST_Y_ATOL = 2e-5
EXT_DIST_Q_RTOL = 1e-5
# (d) examples/elastic_cluster.py's scenario: these four templates, 64
# hosts, seed 0, 40 slots of default_rng(0) arrivals (P = 0.7 a job).
EXT_JOBS = (("qwen2-72b", 4.0, 48.0), ("kimi-k2-1t-a32b", 4.0, 64.0),
            ("mamba2-780m", 2.0, 8.0), ("stablelm-3b", 2.0, 16.0))
EXT_HOSTS = 64
EXT_JOB_SLOTS = 40
# The fused kernel's packed shapes on the extensions path (kernels and
# autotune phases): §3.4 (R*K, L*J) at J = 9, §3.5 (R*K, L*Q), the job
# manager's (hosts*K, jobs), §3.2's rows on 1 and on 4 shards.
EXT_SHAPES = {"multi_arrival": (768, 90), "gang": (768, 40), "job_manager": (384, 4),
              "distributed_1": (786432, 100), "distributed_4": (196608, 100)}
# rows a call of a plain version takes at the extension shapes (plain_rows)
PLAIN_CHUNK_ROWS = 196608
# CUDA-event repeats of the plain version at §3.2's shapes (PLAIN_CHUNK_ROWS
# rows or more): 65-262 ms a call, so TIMING_REPS with the tuner's warm-up
# and spin would take ~40 s of the script's limit
EXT_PLAIN_REPS = 3
# The JAX reference's readings at (a), (b) and (d) on the CPU (jax 0.9.0),
# from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_extensions_pins.py
# "kept" packs every slot's kept-port mask (EXT_GANG_T x L bits).
EXTENSIONS_REFERENCE = {
    "multi": {"J": 9, "avg_reward": 7014.193359375,
              "prefix": ("eNoBkAFv/gAAAAC6wFlFaYTYRZnDsUV+njBF9M/QRfV8ukVPbSdGV0iMRW0nwkXZ8I1FzGib"
                         "RfJAGkadvtdFJUboRQlM9EUJJolF6r6TRWQdCEbmRU9Gup/1Rfgon0VkVLtFcB3sRXLd9kVv"
                         "tOpFHNUERngW80U8Hw5GFbSERWtxlUVN7wdGVF4DRoOClEVwtC1GPt4wRmxJ/EVU9exF9k/q"
                         "RbLZxUUab+pF/mjgRTgwF0ZaSexFrWOARSiDE0YWFeJFxpjxRWDE9EUVqrtFMS3kRaBNtkUE"
                         "AWtFhMDiRdTR9kWUIcdFLGzpRYnpCEZkZQJGnu4ZRu9D3kVemCRG/3VmRTZ+9EWK5Q1GPc/E"
                         "RZQzJEbISgJGBAnjRaR5AUamowBGTfL5ReLUFEZNfpZFOIqhRaY+JUb2XO1FAc30RUywDkaQ"
                         "OgFGEPHiRdo+K0Y50ttFApkHRnCAqEV6IShGON3zRfQl7UWw0rtF3GHjRc3/f0Wk+JdFyOXx"
                         "RcMt2UUWVrBFi6oURqtc4EWfpI9FStuJRfQx7EWpc7a5")},
    "gang": {"sum_q": 2224571.9462890625, "kept": "eNp7XPt/FIwC+gEA2oVuEA=="},
    "jobs": {"grants": [[32, 32, 32, 32], [-1, -1, 64, -1], [64, -1, -1, 64], [-1, 128, -1, 32],
                        [-1, 32, 64, 64], [64, 64, 16, 16], [64, 128, -1, -1], [32, 16, 64, 64],
                        [64, -1, 32, 32], [64, -1, -1, 64], [16, 64, 32, 16], [64, -1, 32, 64],
                        [64, -1, -1, 64], [-1, 64, 32, 32], [64, -1, 32, 64], [16, 64, 32, 32],
                        [128, 32, 32, -1], [32, 64, 32, -1], [64, -1, 32, 64], [64, -1, -1, 64],
                        [-1, 64, 32, -1], [128, -1, -1, -1], [128, -1, -1, -1], [128, -1, -1, -1],
                        [128, -1, -1, -1], [32, 128, -1, -1], [64, 32, 64, -1], [32, -1, 32, 64],
                        [-1, 128, -1, 32], [-1, 64, -1, 64], [128, 32, -1, 32], [32, 64, -1, 64],
                        [64, 32, 64, 32], [-1, 64, 32, 64], [-1, 64, -1, 64], [128, 32, -1, 32],
                        [64, -1, 64, -1], [32, -1, 32, 64], [32, 128, 16, -1], [-1, 64, -1, 64]],
             "meshes": {"16": [1, 16], "32": [2, 16], "64": [4, 16], "128": [8, 16]}},
}


def gang_task_requests(L: int, K: int) -> np.ndarray:
    """(L, EXT_GANG_Q, K) task requests of the §3.5 setup, float32: the
    last task absent (all zero) on even ports."""
    rng = np.random.default_rng(EXT_GANG_SEED)
    req = rng.uniform(0.5, 3.0, (L, EXT_GANG_Q, K)).astype(np.float32)
    req[0::2, EXT_GANG_Q - 1] = 0.0
    return req


def gang_m_min(task_requests: np.ndarray) -> np.ndarray:
    """m_l = ceil(valid tasks / 2), float32 (L,)."""
    valid = (task_requests.sum(-1) > 0).sum(-1)
    return np.ceil(valid / 2.0).astype(np.float32)


def job_arrivals() -> np.ndarray:
    """(EXT_JOB_SLOTS, 4) float32 arrival indicators, drawn slot by slot
    as examples/elastic_cluster.py draws them."""
    rng = np.random.default_rng(0)
    return np.stack([(rng.uniform(size=len(EXT_JOBS)) < 0.7).astype(np.float32)
                     for _ in range(EXT_JOB_SLOTS)])


def pack_floats(a: np.ndarray) -> str:
    """float32 values as zlib, base64 (``unpack_floats``'s inverse)."""
    return base64.b64encode(zlib.compress(np.asarray(a, np.float32).tobytes(), 9)).decode()


def unpack_floats(blob: str) -> np.ndarray:
    return np.frombuffer(zlib.decompress(base64.b64decode(blob)), np.float32)


def pack_bits(a: np.ndarray) -> str:
    """A bool array as packed bits, zlib, base64 (``unpack_events``'s
    inverse)."""
    return base64.b64encode(zlib.compress(np.packbits(a.astype(bool).ravel()).tobytes(),
                                          9)).decode()


def regret_errors(rec: dict, ref: dict) -> dict:
    """A regret_validation record against its pinned reading: r_T_mean's
    error over the bound, the exponent's absolute error (0 when both are
    NaN: too low to fit), the bound's relative error, and whether the
    flags agree."""
    e, w = rec["exponent"], ref["exponent"]
    both_nan = e != e and w != w
    return {"r_T_mean": abs(rec["r_T_mean"] - ref["r_T_mean"]) / ref["bound"],
            "exponent": 0.0 if both_nan else abs(e - w),
            "bound": abs(rec["bound"] - ref["bound"]) / ref["bound"],
            "flags_equal": (rec["bound_ok"], rec["sublinear"]) == (ref["bound_ok"],
                                                                     ref["sublinear"])}


def plain_rows(fn, args, chunk: int = None):
    """A plain row function over row blocks of ``chunk`` (PLAIN_CHUNK_ROWS)
    rows, concatenated: rows are independent, so the values are the
    one-call ones, and the (N, 2L, L) temporaries of the plain sweep stay
    within the card (63 GB at (786432, 100) in one call)."""
    import torch

    chunk = chunk or PLAIN_CHUNK_ROWS
    N = args[0].shape[0]
    return torch.cat([fn(*(t[i:i + chunk] for t in args)) for i in range(0, N, chunk)])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the tuner's CUDA-event method
    (``autotune.device_time_ms``), median of ``reps`` calls."""
    from repro_torch.kernels import autotune
    return autotune.device_time_ms(fn, reps)


def sm_max_clock_hz() -> float:
    """The SM clock's maximum, as nvidia-smi reads it (clocks.max.sm)."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def flash_tanh_exp_pairs(torch, q, k, window, softcap) -> int:
    """Unmasked (query, key) pairs, over every batch row and head, whose
    softcap argument |s| hd^-0.5 / softcap reaches TANH_POLY_LIMIT: the
    pairs on which the bf16 kernel's tanhf issues its ex2 and rcp."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    pos = torch.arange(S, device=q.device)
    lag = pos[:, None] - pos[None, :]
    mask = (lag >= 0) & (lag < window) if window > 0 else lag >= 0
    limit = TANH_POLY_LIMIT * softcap * hd ** 0.5
    n = 0
    for b in range(B):
        for h in range(H):
            s = q[b, :, h].float() @ k[b, :, h // rep].float().T
            n += int(((s.abs() >= limit) & mask).sum())
    return n


def flash_sfu_floor_ms(n_ops, sms, clock_hz) -> float:
    """The special-function units' least time for ``n_ops`` results at
    SFU_PER_CLOCK_PER_SM per clock on every SM: the bf16 kernel's softmax
    floor, with one ex2 per unmasked pair of every head plus an ex2 and an
    rcp on each pair where the softcap's tanhf leaves its polynomial."""
    return n_ops / (sms * SFU_PER_CLOCK_PER_SM * clock_hz) * 1e3


def lse_error(got, want) -> float:
    """The largest |got - want| / max(|want|, 1) of two row log-sum-exps."""
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def lse_checks(torch, label: str, o, fwd, want_lse) -> dict:
    """The forward ``fwd(return_lse=True)`` against its launch without the
    lse (``o``, bit for bit) and its lse against the plain ``want_lse``;
    raises on either."""
    o_l, lse = fwd(return_lse=True)
    row = {"o_bits_with_lse": bool(torch.equal(o, o_l)), "lse_err": lse_error(lse, want_lse)}
    check(row["o_bits_with_lse"], f"{label}: o with the lse written differs from o without")
    check(row["lse_err"] <= FLASH_LSE_RTOL, f"{label}: lse off the plain version's: {row}")
    return row


def flash_bf16_errors(got, want, want_abs) -> dict:
    """The bf16 kernel's error against the plain version: max |diff|, the
    worst element over the bar min(0.05, 1e-4 + 2^-6 |o| + 2^-8 |o|_abs),
    and over the same bar without its |o|_abs term."""
    diff = (got.float() - want.float()).abs()
    base = FLASH_BF16_NEAR0 + FLASH_BF16_RTOL * want.float().abs()
    bar = (base + FLASH_BF16_PROB * want_abs.float()).clamp(max=FLASH_BF16_ATOL)
    return {"max_abs_err": float(diff.max()), "max_err_over_bar": float((diff / bar).max()),
            "max_err_over_bar_without_p_term":
                float((diff / base.clamp(max=FLASH_BF16_ATOL)).max())}


def flash_kernel_ptxas(log: str, marker: str) -> list:
    """ptxas's lines (registers, shared memory, spills) of the kernels whose
    mangled name holds ``marker``, from a build log."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = marker in ln
            name = ln.split("'")[1] if "'" in ln else ln
        elif keep and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def ptxas_by_kernel(log: str) -> dict:
    """ptxas's report of every entry function in a build log: registers,
    barriers, static shared memory, stack frame and spill bytes."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {"registers": None, "barriers": 0, "smem_bytes": 0, "stack_bytes": 0,
                         "spill_store_bytes": 0, "spill_load_bytes": 0}
        elif name and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                             spill_load_bytes=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            ent = out[name]
            ent["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            bars = re.search(r"used (\d+) barriers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            ent["barriers"] = int(bars.group(1)) if bars else 0
            ent["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def sass_ops_by_kernel(lib_path: str) -> dict:
    """How many instructions of each base opcode (``SHFL`` for
    ``SHFL.BFLY``) every function of the built library holds, and their
    ``total``, from cuobjdump -sass. The kernels here are fully unrolled, so
    the total is about what one warp issues."""
    import collections
    import subprocess
    from repro_torch.device import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout.splitlines()
    out, name = {}, None
    for ln in sass:
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            out[name] = collections.Counter()
        elif name and "*/" in ln and ";" in ln:
            words = ln.split("*/", 1)[1].split(";")[0].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                out[name][words[0].split(".")[0]] += 1
                out[name]["total"] += 1
    return out


def flash_f32_build(ptxas: dict) -> dict:
    """ptxas's report of each float32 flash kernel instantiation, by head
    dim (from ``ptxas_by_kernel``)."""
    import re
    out = {}
    for name, rep in ptxas.items():
        hit = re.search(r"flash_attention_f32_kernelILi(\d+)E", name)
        if hit:
            out[int(hit.group(1))] = rep
    return out


def flash_bwd_kernels(ptxas: dict, sass: dict) -> dict:
    """ptxas's registers, stack and spills of each flash backward kernel
    instantiation, as "kernel<hd>" (dK/dV and dQ) or "kernel<dtype>" (the D
    pass), with its SASS count of HGMMA, UTMALDG, LDL and STL instructions
    (from ``ptxas_by_kernel`` and ``sass_ops_by_kernel``)."""
    import re
    out = {}
    for name, rep in ptxas.items():
        hit = re.search(r"(flash_bwd_\w+?_kernel)I(?:Li(\d+)E|(f|13__nv_bfloat16)E)", name)
        if hit:
            arg = hit.group(2) or {"f": "float32"}.get(hit.group(3), "bf16")
            out[f"{hit.group(1)}<{arg}>"] = {
                **{k: rep[k] for k in ("registers", "stack_bytes", "spill_store_bytes",
                                       "spill_load_bytes")},
                **{op: sass.get(name, {}).get(op, 0) for op in ("HGMMA", "UTMALDG", "LDL", "STL")}}
    return out


def sortscan_layout_of(name: str):
    """(kernel, W lanes per row, E slots per lane) of a sortscan kernel's
    mangled name, or None for any other kernel."""
    import re
    hit = re.search(r"(oga_step_sortscan_kernel|proj_sortscan_kernel)ILi(\d+)ELi(\d+)EE", name)
    return (hit.group(1), int(hit.group(2)), int(hit.group(3))) if hit else None


def bisect_layout_of(name: str):
    """(kernel, operand type, W threads a row, Q ports a thread) of a bisect
    kernel's mangled name, or None for any other kernel."""
    import re
    hit = re.search(r"(oga_step_bisect_kernel|proj_bisect_kernel)I(f|\d+__nv_bfloat16)?"
                    r"Li(\d+)ELi(\d+)EE", name)
    if not hit:
        return None
    dtype = {None: "float32", "f": "float32"}.get(hit.group(2), "bf16")
    return hit.group(1), dtype, int(hit.group(3)), int(hit.group(4))


def bisect_network_project(z, a, m, c, iters: int):
    """``proj_bisect_kernel``'s result in float32 numpy, its sums in the
    kernel's order (csrc/bisect.cuh): a thread's ports j + W q in order,
    then the xor butterfly over the row's W lanes (a wide row's 16 warps
    each so, then a butterfly over their sums). The copy in this script of
    tests/_bisect_network.py, which tests/test_torch_bisect_layout.py holds
    to it bit for bit."""
    f32 = np.float32
    n, L = z.shape
    p = 32
    while p < 2 * L:
        p *= 2
    w = 16 if L <= 16 else 32 if L <= 256 else 512
    q = p // (2 * w)

    def lanes(x):
        out = np.zeros((n, w * q), f32)
        out[:, :L] = x
        return out.reshape(n, q, w).transpose(0, 2, 1)

    def fly(x, op):
        j, o = np.arange(x.shape[-1]), x.shape[-1] // 2
        while o:
            x, o = op(x, x[..., j ^ o]), o // 2
        return x

    def reduce(t, op):
        if w > 32:
            t = fly(t.reshape(n, w // 32, 32), op)[:, :, 0]
        return fly(t, op)[:, 0]

    def row_sum(v):
        t = v[..., 0]
        for k in range(1, q):
            t = t + v[..., k]
        return reduce(t, np.add)

    clip = lambda v, hi: np.minimum(np.maximum(v, f32(0)), hi)
    zl, al, ml = (lanes(np.asarray(x, f32)) for x in (z, a, m))
    c = np.asarray(c, f32)
    s_box = row_sum(clip(zl, al) * ml)
    need = s_box > c
    lo = np.maximum((s_box - c) / np.maximum(row_sum(ml), f32(1)), f32(0))
    hi = np.maximum(reduce(np.where(ml > 0, zl, f32(-1e30)).max(-1), np.maximum), lo)
    g = lambda tau: row_sum(clip(zl - tau[:, None, None], al) * ml)
    for _ in range(iters):
        mid = f32(0.5) * (lo + hi)
        big = g(mid) > c
        lo, hi = np.where(big, mid, lo), np.where(big, hi, mid)
    glo, ghi = g(lo), g(hi)
    tau = np.minimum(np.maximum(lo + (glo - c) * (hi - lo) / np.maximum(glo - ghi, f32(1e-30)),
                                lo), hi)
    tau = np.where(need, tau, f32(0))
    z, a, m = (np.asarray(x, f32) for x in (z, a, m))
    return clip(np.where(need[:, None], z - tau[:, None], z), a) * m


def flash_sass_evidence(lib_path: str) -> dict:
    """How many tensor-core (HGMMA) and TMA-load (UTMALDG) instructions the
    built flash library holds, with a first line of each, from cuobjdump."""
    import subprocess
    from repro_torch.device import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout.splitlines()
    ev = {}
    for op in ("HGMMA", "UTMALDG"):
        lines = [ln.strip() for ln in sass if op in ln]
        ev[op] = {"count": len(lines), "first": lines[0] if lines else None}
    return ev


def window_mask(torch, S: int, window: int, dev):
    """The causal mask with a window as SDPA's boolean attn_mask (True:
    the key takes part)."""
    pos = torch.arange(S, device=dev)
    lag = pos[:, None] - pos[None, :]
    return (lag >= 0) & (lag < window)


def sdpa_yardstick(torch, q, k, v, window: int, kernel, atol: float) -> dict:
    """One torch call of the attention without a softcap beside the kernel
    on the same inputs (``kernel()``, also without): SDPA with is_causal for
    a global layer, with the boolean window mask for a windowed one. bf16
    global layers pass enable_gqa (the flash backend takes it); elsewhere
    the KV heads are expanded to the query heads outside the timed call,
    so that the backends that take a mask or float32 (memory-efficient)
    are open to it. Its time, the kernel's, and their largest difference,
    held to ``atol``."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    expand = window > 0 or q.dtype != torch.bfloat16
    if expand:
        rep = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
    if window > 0:
        mask = window_mask(torch, q.shape[1], window, q.device)
        call = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        name = f"scaled_dot_product_attention(attn_mask=<causal window {window}>)"
    else:
        call = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=not expand)
        name = f"scaled_dot_product_attention(is_causal=True, enable_gqa={not expand})"
    name = "torch.nn.functional." + name + (", KV heads expanded" if expand else "")
    err = float((call().transpose(1, 2).float() - kernel().float()).abs().max())
    check(err <= atol, f"flash without softcap vs SDPA ({q.dtype}, window {window}): {err}")
    return {"call": name, "dtype": str(q.dtype).split(".")[-1], "softcap": None,
            "window": window, "library_ms": device_ms(call, FLASH_TIMING_REPS),
            "kernel_ms": device_ms(kernel, FLASH_TIMING_REPS),
            "kernel_vs_library_max_abs": err, "atol": atol}


def flash_phase(torch, dev) -> dict:
    """Both flash kernels against their plain version on the card; times at
    gemma2-27b's prefill shape. Launches made here are not a path's."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels import _launch, build, ops, ref
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = sm_max_clock_hz()

    def qkv(B, S, H, G, hd, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd))]

    small = {"float32": [], "bfloat16": []}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, window, cap in FLASH_SMALL_CASES:
            q, k, v = qkv(*shape, dtype)
            fwd = lambda **kw: ops.flash_attention(q, k, v, window=window, softcap=cap, **kw)
            got = fwd()
            want, want_lse = ref.flash_attention_ref(q, k, v, window=window, softcap=cap,
                                                     return_lse=True)
            torch.cuda.synchronize()
            row = {"B_S_H_G_hd": shape, "window": window, "softcap": cap,
                   **lse_checks(torch, f"flash {dtype} {shape} window={window} softcap={cap}",
                                got, fwd, want_lse)}
            if dtype == torch.float32:
                row["max_abs_err"] = float((got - want).abs().max())
                check(row["max_abs_err"] <= FLASH_F32_ATOL,
                      f"flash float32 {shape} window={window} softcap={cap}: {row}")
            else:
                want_abs = ref.flash_attention_ref(q, k, v.abs(), window=window, softcap=cap)
                row.update(flash_bf16_errors(got, want, want_abs))
                check(row["max_err_over_bar"] <= 1.0,
                      f"flash bf16 {shape} window={window} softcap={cap}: {row}")
            small[str(dtype).split(".")[-1]].append(row)

    B, S, H, G, hd = 1, LM_SEQ, 32, 16, 128
    q, k, v = qkv(B, S, H, G, hd, torch.bfloat16)
    path = {}
    for label, window in (("global", 0), ("window4096", 4096)):
        run = lambda **kw: ops.flash_attention(q, k, v, window=window, softcap=50.0, **kw)
        plain = lambda: ref.flash_attention_ref(q, k, v, window=window, softcap=50.0)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=window, softcap=50.0,
                                                 return_lse=True)
        want_abs = ref.flash_attention_ref(q, k, v.abs(), window=window, softcap=50.0)
        got = run()
        row = {**flash_bf16_errors(got, want, want_abs),
               **lse_checks(torch, f"flash path shape bf16 {label}", got, run, want_lse)}
        del want_abs, got, want_lse
        check(row["max_err_over_bar"] <= 1.0, f"flash path shape bf16 {label}: {row}")
        t_b, by = rl.flash_bound(B, S, H, G, hd, window, 2)
        tanh_exp_pairs = flash_tanh_exp_pairs(torch, q, k, window, 50.0)
        path[label] = {"B_S_H_G_hd": (B, S, H, G, hd), "dtype": "bfloat16", "window": window,
                       "softcap": 50.0, **row,
                       "median_abs_o": float(want.float().abs().median()),
                       "ms": device_ms(run, FLASH_TIMING_REPS),
                       "plain_ms": device_ms(plain, FLASH_TIMING_REPS),
                       "bound_ms": t_b, "bound_by": by,
                       "sfu_floor_ms": flash_sfu_floor_ms(
                           B * H * rl.flash_pairs(S, window) + 2 * tanh_exp_pairs, sms, clock_hz),
                       "tanh_exp_pairs": tanh_exp_pairs,
                       "pairs": rl.flash_pairs(S, window)}
    # the library yardstick: one torch call of the same function without the
    # softcap (no single call softcaps), beside the kernel on those inputs
    library = {label: sdpa_yardstick(torch, q, k, v, window,
                                     lambda: ops.flash_attention(q, k, v, window=window),
                                     FLASH_BF16_ATOL)
               for label, window in (("global", 0), ("window4096", 4096))}
    library["global"]["kernel_sfu_floor_ms"] = flash_sfu_floor_ms(B * H * rl.flash_pairs(S, 0), sms,
                                                                  clock_hz)
    library["softcapped"] = "no single PyTorch call computes the softcapped function"
    del q, k, v
    torch.cuda.empty_cache()
    # float32 at the path shape: times beside the bound, the launch floor
    # (an empty kernel on the kernel's grid, block and shared memory) and
    # SDPA in float32; a tile schedule that goes wrong only at S = 8192
    # shows here at the reference's float32 bar
    floor = _launch.c_entry("flash_attention.cu", "repro_flash_attention_floor",
                            (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    path_f32, library_f32 = {}, {}
    q, k, v = qkv(B, S, H, G, hd, torch.float32)
    for label, window in (("global", 0), ("window4096", 4096)):
        run = lambda **kw: ops.flash_attention(q, k, v, window=window, softcap=50.0, **kw)
        plain = lambda: ref.flash_attention_ref(q, k, v, window=window, softcap=50.0)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=window, softcap=50.0,
                                                 return_lse=True)
        got = run()
        err = float((got - want).abs().max())
        check(err <= FLASH_F32_ATOL, f"flash path shape float32 {label}: max abs err {err}")
        lse_row = lse_checks(torch, f"flash path shape float32 {label}", got, run, want_lse)
        del got, want, want_lse
        t_b, by = rl.flash_bound(B, S, H, G, hd, window, 4, rl.FP32_FLOPS)
        path_f32[label] = {"B_S_H_G_hd": (B, S, H, G, hd), "window": window, "softcap": 50.0,
                           "max_abs_err": err, **lse_row, "ms": device_ms(run, FLASH_TIMING_REPS),
                           "plain_ms": device_ms(plain, FLASH_TIMING_REPS),
                           "bound_ms": t_b, "bound_by": by,
                           "launch_floor_ms": device_ms(
                               lambda: _launch.call(floor, dev, B, S, H, G, hd),
                               FLASH_TIMING_REPS),
                           "layout_groups_heads_positions": fa.f32_layout(H // G)}
        library_f32[label] = sdpa_yardstick(
            torch, q, k, v, window, lambda: ops.flash_attention(q, k, v, window=window),
            FLASH_F32_SDPA_ATOL)
    del q, k, v
    torch.cuda.empty_cache()
    # lm_families' full-width prefill shapes in bf16: kernel against plain,
    # times, bound, and SDPA on the same inputs (no softcap in these configs)
    families = {}
    for arch, (shape, window) in FAMILY_FLASH_SHAPES.items():
        q, k, v = qkv(*shape, torch.bfloat16)
        run = lambda: ops.flash_attention(q, k, v, window=window)
        plain = lambda: ref.flash_attention_ref(q, k, v, window=window)
        want_abs = ref.flash_attention_ref(q, k, v.abs(), window=window)
        row = flash_bf16_errors(run(), plain(), want_abs)
        del want_abs
        check(row["max_err_over_bar"] <= 1.0, f"flash {arch} shape bf16: {row}")
        t_b, by = rl.flash_bound(*shape, window, 2)
        sdpa = sdpa_yardstick(torch, q, k, v, window, run, FLASH_BF16_ATOL)
        families[arch] = {"B_S_H_G_hd": shape, "window": window, "softcap": None, **row,
                          "ms": device_ms(run, FLASH_TIMING_REPS),
                          "plain_ms": device_ms(plain, FLASH_TIMING_REPS),
                          "bound_ms": t_b, "bound_by": by, "pairs": rl.flash_pairs(shape[1], window),
                          "library_ms": sdpa["library_ms"], "library_call": sdpa["call"],
                          "kernel_vs_library_max_abs": sdpa["kernel_vs_library_max_abs"]}
        del q, k, v
    torch.cuda.empty_cache()
    lib = str(build.library_path("flash_attention.cu"))
    log = build.library_path("flash_attention.cu").with_suffix(".log").read_text()
    return {"phase": "flash", "phase_s": time.perf_counter() - t_phase,
            "small": small, "path_f32": path_f32, "path_bf16": path, "library": library,
            "families_bf16": families,
            "library_f32": library_f32,
            "f32_atol": FLASH_F32_ATOL,
            "bf16_bar": f"min({FLASH_BF16_ATOL}, {FLASH_BF16_NEAR0} + {FLASH_BF16_RTOL} |o| + "
                        f"{FLASH_BF16_PROB} |o|_abs)",
            "sdpa_atol": {"bfloat16": FLASH_BF16_ATOL, "float32": FLASH_F32_SDPA_ATOL},
            "sfu": {"sms": sms, "clock_max_hz": clock_hz, "per_clock_per_sm": SFU_PER_CLOCK_PER_SM,
                    "ops_per_pair": "1 ex2; 2 more where tanhf leaves its polynomial",
                    "tanh_poly_limit": TANH_POLY_LIMIT},
            "ptxas_bf16_kernel": flash_kernel_ptxas(log, "wgmma"),
            "ptxas_f32_kernel": flash_kernel_ptxas(log, "f32_kernel"),
            "sass_bf16_library": flash_sass_evidence(lib),
            "timing": f"device time, median of {FLASH_TIMING_REPS} calls between CUDA events"}


def reduced_lm_phase(torch, dev) -> dict:
    """The reduced configs as they are (float32, head dim 16; gemma's with a
    window and a softcap): model.prefill on the card against the same call
    on the CPU, each layer through the float32 kernel. Launches made here
    are not a path's."""
    from repro_torch.configs import base as configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    rows = {}
    for i, arch in enumerate(REDUCED_ARCHS):
        cfg = configs.reduced(configs.get(arch))
        params = M.init_params(cfg, LM_SEED, "cpu")
        rng = np.random.default_rng(np.random.SeedSequence(LM_SEED, spawn_key=(i,)))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, REDUCED_TOKENS))
        want, wcache = M.prefill(params, cfg, {"tokens": toks})
        before = fa.flash_attention.kernel_launches["float32"]
        got, gcache = M.prefill(to_device(params, dev), cfg, {"tokens": toks.to(dev)})
        torch.cuda.synchronize()
        rows[arch] = {"heads": [cfg.n_heads, cfg.n_kv, cfg.hd], "layers": cfg.n_layers,
                      "window": cfg.window, "attn_softcap": cfg.attn_softcap,
                      "tokens": list(REDUCED_TOKENS),
                      "f32_launches": fa.flash_attention.kernel_launches["float32"] - before,
                      "max_abs_dlogit": float((got.cpu() - want).abs().max()),
                      "max_abs_dcache_k": float((gcache["k"].cpu() - wcache["k"]).abs().max()),
                      "max_abs_logit": float(want.abs().max())}
        emit({"phase": "reduced_lm", "arch": arch, **rows[arch]})
        check(rows[arch]["f32_launches"] == cfg.n_layers,
              f"reduced {arch}: {rows[arch]['f32_launches']} float32 flash launches")
        check(bool(torch.isfinite(got).all()), f"reduced {arch}: logits not finite")
        check(rows[arch]["max_abs_dlogit"] <= REDUCED_LOGIT_ATOL
              and rows[arch]["max_abs_dcache_k"] <= REDUCED_LOGIT_ATOL,
              f"reduced {arch}: card vs CPU {rows[arch]}")
    # the int8 KV cache, card against CPU
    cfg = configs.reduced(configs.get(REDUCED_INT8_ARCH), kv_cache_quant=True)
    params = M.init_params(cfg, LM_SEED, "cpu")
    rng = np.random.default_rng(np.random.SeedSequence(LM_SEED, spawn_key=(len(REDUCED_ARCHS),)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, REDUCED_TOKENS))
    want = prefill_then_decode(torch, M, tf, params, cfg, {"tokens": toks}, REDUCED_INT8_STEPS)
    got = prefill_then_decode(torch, M, tf, to_device(params, dev), cfg, {"tokens": toks.to(dev)},
                              REDUCED_INT8_STEPS)
    int8 = int8_card_vs_cpu(torch, got, want)
    int8_bar = REDUCED_LOGIT_ATOL + INT8_FLIP_LOGIT * int8["codes_differing"]
    emit({"phase": "reduced_lm", "arch": REDUCED_INT8_ARCH, "kv_cache_quant": True,
          "decode_steps": REDUCED_INT8_STEPS, **int8, "decode_bar": int8_bar})
    check(int8["finite"] and int8["prefill_max_abs_dlogit"] <= REDUCED_LOGIT_ATOL,
          f"reduced int8: prefill card vs CPU {int8}")
    check(int8["max_abs_dcode"] <= 1 and int8["max_abs_dscale"] <= REDUCED_LOGIT_ATOL / 127,
          f"reduced int8: cache card vs CPU {int8}")
    check(int8["decode_max_abs_dlogit"] <= int8_bar, f"reduced int8: decode card vs CPU {int8}")
    # the other families: prefill, then REDUCED_DECODE_STEPS decode steps
    for j, arch in enumerate(REDUCED_FAMILY_ARCHS):
        cfg = configs.reduced(configs.get(arch))
        params = M.init_params(cfg, LM_SEED, "cpu")
        batch = lm_batch(torch, M, cfg, REDUCED_TOKENS[0], REDUCED_TOKENS[1], (10 + j,), "cpu")
        want_l, want_d, want_c = prefill_then_decode(torch, M, tf, params, cfg, batch,
                                                     REDUCED_DECODE_STEPS)
        before = fa.flash_attention.kernel_launches["float32"]
        got_l, got_d, got_c = prefill_then_decode(
            torch, M, tf, to_device(params, dev), cfg, to_device(batch, dev), REDUCED_DECODE_STEPS)
        torch.cuda.synchronize()
        row = {"family": cfg.family, "layers": cfg.n_layers, "tokens": list(REDUCED_TOKENS),
               "patches": cfg.n_patches, "decode_steps": REDUCED_DECODE_STEPS,
               "f32_launches": fa.flash_attention.kernel_launches["float32"] - before,
               "prefill_max_abs_dlogit": float((got_l.cpu() - want_l).abs().max()),
               "decode_max_abs_dlogit": float((got_d.cpu() - want_d).abs().max()),
               "cache_max_abs_diff_over_max": {
                   n: float((got_c[n].cpu().float() - want_c[n].float()).abs().max()
                            / max(float(want_c[n].float().abs().max()), 1.0))
                   for n in want_c},
               "max_abs_logit": float(want_d.abs().max()),
               "finite": bool(torch.isfinite(got_l).all() and torch.isfinite(got_d).all())}
        rows[arch] = row
        emit({"phase": "reduced_lm", "arch": arch, **row})
        attn_layers = cfg.n_layers if cfg.has_attn else 0
        check(row["f32_launches"] == attn_layers,
              f"reduced {arch}: {row['f32_launches']} float32 flash launches, "
              f"{attn_layers} attention layers")
        check(row["finite"], f"reduced {arch}: logits not finite")
        check(row["prefill_max_abs_dlogit"] <= REDUCED_LOGIT_ATOL
              and row["decode_max_abs_dlogit"] <= REDUCED_LOGIT_ATOL
              and max(row["cache_max_abs_diff_over_max"].values()) <= REDUCED_LOGIT_ATOL,
              f"reduced {arch}: card vs CPU {row}")
    return {"phase": "reduced_lm", "phase_s": time.perf_counter() - t_phase,
            "atol": REDUCED_LOGIT_ATOL, "archs": list(rows), "int8_arch": REDUCED_INT8_ARCH}


def lm_batch(torch, M, cfg, B: int, n_tokens: int, spawn_key: tuple, dev) -> dict:
    """A seeded prompt batch on ``dev``: ``n_tokens`` tokens a row and, for
    vlm, cfg.n_patches patch embeddings (float32 N(0, 1)) before them."""
    rng = np.random.default_rng(np.random.SeedSequence(LM_SEED, spawn_key=spawn_key))
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, n_tokens))).to(dev)}
    if cfg.family == "vlm":
        pe = rng.standard_normal((B, cfg.n_patches, M.PATCH_DIM), dtype=np.float32)
        batch["patch_embeds"] = torch.from_numpy(pe).to(dev)
    return batch


def to_device(params, dev):
    """A model's parameter tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(params, dict):
        return {k: to_device(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, dev) for v in params]
    return params.to(dev)


def device_profile(torch, fn, n_top: int = 8) -> dict:
    """Run ``fn`` once under torch.profiler: its wall time, the device time
    of its CUDA kernels (which run on one stream, so never overlap), the
    share of the wall time the card sat idle, and the kernels that took the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy = sum(t for t, _, _ in kernels)
    kernels.sort(reverse=True)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if busy else None,
            "host_ops": sum(ev.count for ev in prof.key_averages()
                            if ev.device_type == DeviceType.CPU and ev.key.startswith("aten::")),
            "top_kernels_ms": [(k[:60], n, t / 1e3) for t, n, k in kernels[:n_top]]}


def pad_cache(torch, tf, cache: dict, n: int) -> dict:
    """A prefill's cache with ``n`` empty slots appended on the sequence
    axis (zeros; kpos EMPTY_KPOS), every attention entry (the int8 cache's
    scales too); the SSM's conv window and state, which have no sequence
    axis, as they are."""
    pad = lambda c, fill: torch.cat([c, torch.full_like(c[:, :, :n], fill)], dim=2)
    return {k: v if k in tf.SSM_CACHE else pad(v, tf.EMPTY_KPOS if k == "kpos" else 0)
            for k, v in cache.items()}


def prefill_then_decode(torch, M, tf, params, cfg, batch, steps: int):
    """prefill(batch), then ``steps`` serve_steps after it (token i of the
    prompt fed at position S + i, S the prompt's length with any patches).
    Returns (prefill's logits, the steps' logits (steps, B, vocab), the
    final cache)."""
    toks = batch["tokens"]
    S = toks.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    logits, cache = M.prefill(params, cfg, batch)
    cache = pad_cache(torch, tf, cache, steps)
    outs = []
    for i in range(steps):
        lg, cache = M.serve_step(params, cfg, cache, toks[:, i:i + 1], S + i)
        outs.append(lg)
    return logits, torch.stack(outs), cache


def int8_card_vs_cpu(torch, got, want) -> dict:
    """prefill_then_decode's outputs on the card against the CPU's: the
    prefill's and the decode's max |Δlogit|, the int8 codes that differ
    and by how much at most, and the scales' largest difference."""
    (gl, gd, gc), (wl, wd, wc) = got, want
    dcode = {n: (gc[n].cpu().to(torch.int16) - wc[n].to(torch.int16)).abs() for n in ("k", "v")}
    return {"prefill_max_abs_dlogit": float((gl.cpu() - wl).abs().max()),
            "decode_max_abs_dlogit": float((gd.cpu() - wd).abs().max()),
            "codes_differing": int(sum(int((d > 0).sum()) for d in dcode.values())),
            "codes": int(sum(d.numel() for d in dcode.values())),
            "max_abs_dcode": int(max(int(d.max()) for d in dcode.values())),
            "max_abs_dscale": float(max((gc[n].cpu() - wc[n]).abs().max()
                                        for n in ("k_scale", "v_scale"))),
            "finite": bool(torch.isfinite(gd).all())}


def decode_after_prefill(torch, M, tf, params, cfg, prompt):
    """prefill(prompt[:, :S - 1]), its cache padded by one empty slot, one
    serve_step at position S - 1, against prefill(prompt)'s last logits
    (tests/test_arch_smoke.py). Returns (prefill's logits, the step's)."""
    S = prompt.shape[1]
    full, cache = M.prefill(params, cfg, {"tokens": prompt})
    del cache
    _, cache = M.prefill(params, cfg, {"tokens": prompt[:, :S - 1]})
    cache = pad_cache(torch, tf, cache, 1)
    step, cache = M.serve_step(params, cfg, cache, prompt[:, S - 1:], S - 1)
    del cache
    return full, step


def compare_logits(torch, full, step) -> dict:
    top2 = torch.topk(full[0], 2).values
    return {"max_abs_dlogit": float((full - step).abs().max()),
            "argmax_prefill": int(full.argmax()), "argmax_decode": int(step.argmax()),
            "top2_gap_prefill": float(top2[0] - top2[1]),
            "finite": bool(torch.isfinite(full).all() and torch.isfinite(step).all())}


def lm_prefill_phase(torch, dev):
    """gemma2-27b at full width: the float32 check at 2 layers, then all 46
    layers in bf16. Returns (the phase's line, the bf16 config, params)."""
    import dataclasses

    from repro_torch.configs import base as configs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    cfg = configs.get(LM_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    prompt = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen, device=dev)

    # float32, every width of gemma2-27b, depth cut to 2 (one local, one global)
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = M.init_params(cfg32, LM_SEED, dev)
    f32 = compare_logits(torch, *decode_after_prefill(torch, M, tf, params, cfg32, prompt))
    del params
    torch.cuda.empty_cache()
    f32["layers"] = cfg32.n_layers
    check(f32["finite"], "lm_prefill float32: logits not finite")
    check(f32["max_abs_dlogit"] <= LM_F32_DECODE_ATOL,
          f"lm_prefill float32: decode vs prefill max |dlogit| {f32['max_abs_dlogit']}")

    # bf16, all 46 layers
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, LM_SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    times = []
    for _ in range(1 + LM_PREFILL_REPS):  # the first is the warm-up
        torch.cuda.synchronize()
        n0 = fa.flash_attention.launches
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cfg, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(fa.flash_attention.launches - n0 == cfg.n_layers,
              f"lm_prefill: {fa.flash_attention.launches - n0} flash launches in one prefill")
        check(tuple(cache["k"].shape) == (cfg.n_layers, 1, LM_SEQ, cfg.n_kv, cfg.hd),
              f"lm_prefill: cache of shape {tuple(cache['k'].shape)}")
        del cache
    check(tuple(logits.shape) == (1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "lm_prefill: last-token logits not finite or of the wrong shape")
    check(float(logits.abs().max()) <= cfg.final_softcap, "lm_prefill: logits above the softcap")
    peak = torch.cuda.max_memory_allocated()
    peak_gb = peak / 1e9
    pred = dryrun_prediction("lm_prefill", cfg, ShapeConfig("prompt", LM_SEQ, 1, "prefill"),
                             sum(t.nbytes for t in _leaves(params)), peak)
    profile = device_profile(torch, lambda: M.prefill(params, cfg, {"tokens": prompt}))
    full, step = decode_after_prefill(torch, M, tf, params, cfg, prompt)
    bf16 = compare_logits(torch, full, step)
    bf16["layers"] = cfg.n_layers
    # the same check with the int8 KV cache on the same weights
    cfg8 = dataclasses.replace(cfg, kv_cache_quant=True)
    int8 = compare_logits(torch, *decode_after_prefill(torch, M, tf, params, cfg8, prompt))
    _, cache8 = M.prefill(params, cfg8, {"tokens": prompt})
    kv_bytes = lambda c: sum(c[n].nbytes for n in ("k", "v", "k_scale", "v_scale") if n in c)
    int8["prefill_cache_kv_bytes"] = kv_bytes(cache8)
    int8["bf16_prefill_cache_kv_bytes"] = 2 * cfg.n_layers * LM_SEQ * cfg.n_kv * cfg.hd * 2
    del cache8
    # the same prefill with the plain attention in the kernel's place
    plain = plain_attention_prefill(M, attn_lib, ref, params, cfg, {"tokens": prompt})
    vs_plain = compare_logits(torch, full, plain)
    ms = statistics.median(times[1:])
    line = {"phase": "lm_prefill", "phase_s": time.perf_counter() - t_phase,
            "arch": LM_ARCH, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
            "window": cfg.window, "softcaps": [cfg.attn_softcap, cfg.final_softcap],
            "params": n_params, "prompt_tokens": LM_SEQ, "init_s": init_s,
            "ms_per_prefill": ms, "ms_per_prefill_all": times,
            "prefill_tokens_per_s": LM_SEQ / (ms / 1e3),
            "peak_memory_gb": peak_gb, "prefill_profile": profile,
            "bf16_decode_vs_prefill": bf16, "int8_cache_decode_vs_prefill": int8,
            "bf16_kernel_vs_plain_attention_prefill": vs_plain,
            "f32_2_layers_decode_vs_prefill": f32,
            "bars": {"bf16_max_abs_dlogit": LM_BF16_DECODE_ATOL,
                     "f32_max_abs_dlogit": LM_F32_DECODE_ATOL},
            "bf16_reduced_precision_reduction": False, "dryrun": pred}
    emit(line)
    hold_prediction("lm_prefill", pred)
    check(bf16["finite"], "lm_prefill bf16: logits not finite")
    check(bf16["argmax_prefill"] == bf16["argmax_decode"],
          f"lm_prefill bf16: decode argmax {bf16['argmax_decode']} != prefill "
          f"{bf16['argmax_prefill']}")
    check(bf16["max_abs_dlogit"] <= LM_BF16_DECODE_ATOL,
          f"lm_prefill bf16: decode vs prefill max |dlogit| {bf16['max_abs_dlogit']}")
    check(vs_plain["finite"] and vs_plain["max_abs_dlogit"] <= LM_BF16_DECODE_ATOL,
          f"lm_prefill bf16: kernel vs plain attention prefill {vs_plain['max_abs_dlogit']}")
    check(int8["finite"] and int8["argmax_prefill"] == int8["argmax_decode"],
          f"lm_prefill int8 cache: decode argmax {int8['argmax_decode']} != prefill "
          f"{int8['argmax_prefill']}")
    check(int8["max_abs_dlogit"] <= LM_BF16_DECODE_ATOL,
          f"lm_prefill int8 cache: decode vs prefill max |dlogit| {int8['max_abs_dlogit']}")
    check(int8["prefill_cache_kv_bytes"] * 2 * cfg.hd
          == int8["bf16_prefill_cache_kv_bytes"] * (cfg.hd + 4),
          f"lm_prefill int8 cache: {int8['prefill_cache_kv_bytes']} bytes of K/V and scales")
    return cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def lm_serve_phase(torch, dev, cfg, params) -> dict:
    """The Engine at gemma2-27b's full width: every request finishes with
    SERVE_NEW_TOKENS tokens, and the logits of the step that gives its
    first token (the decode path, fed the prompt one token per step) are
    held against prefill(prompt)'s last logits."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, Request

    t_phase = time.perf_counter()
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 65, SERVE_REQUESTS)]
    prefilled = []
    for p in prompts:
        logits, cache = M.prefill(params, cfg, {"tokens": torch.tensor([p], device=dev)})
        del cache
        prefilled.append(logits[0])
    eng = Engine(cfg, params, slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN, device=dev)
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    for r in reqs:
        eng.submit(r)
    first_logits = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        for s, r in enumerate(eng.active):
            if r is not None and len(r.out) == 1 and id(r) not in first_logits:
                first_logits[id(r)] = eng.last_logits[s].clone()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = eng.steps_run
    generated = sum(len(r.out) for r in reqs)
    # a profiled window of 5 steps over 4 fresh requests, after 3 warm steps
    for p in prompts[:SERVE_SLOTS]:
        eng.submit(Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS))
    for _ in range(3):
        eng.step()
    profile = device_profile(torch, lambda: [eng.step() for _ in range(5)])
    bf16_bytes = sum(eng.cache[n].nbytes for n in ("k", "v"))
    del eng
    # the same requests on the int8 KV cache: the cache's bytes against
    # the int8 + scale arithmetic (the allocator's growth, which rounds
    # segments up, recorded beside them), the greedy tokens against the
    # bf16 cache's
    cfg8 = dataclasses.replace(cfg, kv_cache_quant=True)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    probe = tf.init_cache(cfg8, SERVE_SLOTS, SERVE_CACHE_LEN, M.compute_dtype(cfg), dev)
    int8_alloc = torch.cuda.memory_allocated() - mem0
    int8_bytes = sum(probe[n].nbytes for n in ("k", "v", "k_scale", "v_scale"))
    kpos_bytes = probe["kpos"].nbytes
    del probe
    eng8 = Engine(cfg8, params, slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN, device=dev)
    reqs8 = [Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    for r in reqs8:
        eng8.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng8.run()
    torch.cuda.synchronize()
    seconds8 = time.perf_counter() - t0
    steps8 = eng8.steps_run
    del eng8
    int8 = {"kv_bytes": int8_bytes, "bf16_kv_bytes": bf16_bytes,
            "ratio": int8_bytes / bf16_bytes, "arithmetic": (cfg.hd + 4) / (2 * cfg.hd),
            "allocated_bytes": int8_alloc, "kpos_bytes": kpos_bytes,
            "engine_steps": steps8, "ms_per_step": seconds8 * 1e3 / steps8,
            "generated_tokens_per_s": sum(len(r.out) for r in reqs8) / seconds8,
            "tokens": [r.out for r in reqs8],
            "requests_equal_bf16": sum(a.out == b.out for a, b in zip(reqs8, reqs)),
            "tokens_equal_bf16": sum(x == y for a, b in zip(reqs8, reqs)
                                     for x, y in zip(a.out, b.out)),
            "first_tokens_equal_bf16": sum(a.out[:1] == b.out[:1] for a, b in zip(reqs8, reqs))}
    rows = []
    for r, want in zip(reqs, prefilled):
        got = first_logits[id(r)]
        top2 = torch.topk(want, 2).values
        rows.append({"prompt_tokens": len(r.prompt), "new_tokens": len(r.out),
                     "first_token": r.out[0], "prefill_argmax": int(want.argmax()),
                     "step_argmax": int(got.argmax()),
                     "prefill_top2_gap": float(top2[0] - top2[1]),
                     "max_abs_dlogit": float((got - want).abs().max())})
    line = {"phase": "lm_serve", "phase_s": time.perf_counter() - t_phase,
            "arch": LM_ARCH, "layers": cfg.n_layers,
            "slots": SERVE_SLOTS, "cache_len": SERVE_CACHE_LEN, "requests": SERVE_REQUESTS,
            "new_tokens": SERVE_NEW_TOKENS, "engine_steps": steps, "seconds": seconds,
            "ms_per_step": seconds * 1e3 / steps,
            "generated_tokens_per_s": generated / seconds,
            "step_profile_5_steps": profile,
            "first_token_vs_prefill": rows, "bar_max_abs_dlogit": LM_BF16_DECODE_ATOL,
            "tie_gap": SERVE_TIE_GAP,
            "first_tokens_equal_prefill_argmax": sum(r["first_token"] == r["prefill_argmax"]
                                                     for r in rows),
            "bf16_tokens": [r.out for r in reqs], "int8_cache": int8}
    emit(line)
    check(int8_bytes * 2 * cfg.hd == bf16_bytes * (cfg.hd + 4),
          f"lm_serve int8 cache: {int8_bytes} bytes of K/V and scales against {bf16_bytes} bf16")
    check(all(len(r.out) == SERVE_NEW_TOKENS and r.done for r in reqs8),
          "lm_serve int8 cache: a request ended early")
    for i, row in enumerate(rows):
        check(row["new_tokens"] == SERVE_NEW_TOKENS and reqs[i].done,
              f"lm_serve: request {i} ended with {row['new_tokens']} tokens")
        check(row["first_token"] == row["step_argmax"],
              f"lm_serve: request {i} took {row['first_token']}, its step's argmax is "
              f"{row['step_argmax']}")
        check(row["max_abs_dlogit"] <= LM_BF16_DECODE_ATOL,
              f"lm_serve: request {i} first-step logits vs prefill {row['max_abs_dlogit']}")
        check(row["first_token"] == row["prefill_argmax"]
              or row["prefill_top2_gap"] <= SERVE_TIE_GAP,
              f"lm_serve: request {i} first token {row['first_token']} != prefill argmax "
              f"{row['prefill_argmax']} with a top-2 gap of {row['prefill_top2_gap']}")
    return line


def attention_layers(cfg) -> int:
    """The layers of a config that run the flash kernel in prefill."""
    return cfg.n_layers if cfg.has_attn else 0


def no_drop(cfg):
    """An MoE config at capacity_factor E / k, where C = T and no
    assignment can drop; any other config as it is."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def rows_vs(torch, want, got) -> dict:
    """Logit rows (..., vocab), got against want: the largest |Δlogit|,
    how many rows' argmax differ, and the largest top-2 gap of want's
    among those rows (a logit bar forbids a difference past twice itself)."""
    top2 = torch.topk(want, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = want.argmax(-1) != got.argmax(-1)
    return {"rows": int(gap.numel()), "max_abs_dlogit": float((want - got).abs().max()),
            "argmax_differ": int(differ.sum()),
            "max_top2_gap_where_argmax_differs": float(torch.where(differ, gap, 0.0).max()),
            "min_top2_gap": float(gap.min()),
            "finite": bool(torch.isfinite(want).all() and torch.isfinite(got).all())}


def plain_attention_prefill(M, attn_lib, ref, params, cfg, batch):
    """model.prefill's logits with the plain attention in the kernel's
    place."""
    real = attn_lib.attention
    attn_lib.attention = lambda q, k, v, window=None, attn_softcap=None: \
        ref.flash_attention_ref(q, k, v, window=window, softcap=attn_softcap)
    try:
        logits, cache = M.prefill(params, cfg, batch)
        del cache
    finally:
        attn_lib.attention = real
    return logits


def family_decode_check(torch, params, cfg, dev, spawn_key) -> dict:
    """Decode against prefill, by family (module docstring, lm_families)."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf

    if cfg.n_experts:
        cfg = no_drop(cfg)
        batch = lm_batch(torch, M, cfg, 1, MOE_DECODE_SEQ, spawn_key, dev)
        full, step = decode_after_prefill(torch, M, tf, params, cfg, batch["tokens"])
        return {"check": "prefill(S - 1) + serve_step vs prefill(S), capacity_factor E / k",
                "prompt_tokens": MOE_DECODE_SEQ, "capacity_factor": cfg.capacity_factor,
                **rows_vs(torch, full, step)}
    if cfg.has_ssm:
        return teacher_forced(torch, params, cfg, dev, spawn_key, SSM_DECODE_STEPS)
    if cfg.family == "vlm":
        batch = lm_batch(torch, M, cfg, 1, FAMILY_SEQ - cfg.n_patches, spawn_key, dev)
        kernel, cache = M.prefill(params, cfg, batch)
        del cache
        plain = plain_attention_prefill(M, attn_lib, ref, params, cfg, batch)
        return {"check": "prefill with the flash kernel vs with the plain attention "
                         "(the reference's decode positions are not prefill's)",
                "prompt_tokens": FAMILY_SEQ, **rows_vs(torch, plain, kernel)}
    toks = lm_batch(torch, M, cfg, 1, FAMILY_SEQ, spawn_key, dev)["tokens"]
    full, step = decode_after_prefill(torch, M, tf, params, cfg, toks)
    return {"check": "prefill(S - 1) + serve_step vs prefill(S)", "prompt_tokens": FAMILY_SEQ,
            **rows_vs(torch, full, step)}


def teacher_forced(torch, params, cfg, dev, spawn_key, n: int) -> dict:
    """prefill(S - SSM_DECODE_STEPS) (a legal SSD length), then n <=
    SSM_DECODE_STEPS teacher-forced serve_steps, each step's logits against
    forward(S) at its position (S = FAMILY_SEQ)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf

    S, p = FAMILY_SEQ, FAMILY_SEQ - SSM_DECODE_STEPS
    toks = lm_batch(torch, M, cfg, 1, S, spawn_key, dev)["tokens"]
    full = M.forward(params, cfg, {"tokens": toks})[0, p:p + n]
    _, cache = M.prefill(params, cfg, {"tokens": toks[:, :p]})
    cache = pad_cache(torch, tf, cache, n)
    steps = []
    for pos in range(p, p + n):
        lg, cache = M.serve_step(params, cfg, cache, toks[:, pos:pos + 1], pos)
        steps.append(lg[0])
    del cache
    return {"check": f"prefill(S - {S - p}) + {n} teacher-forced serve_steps vs forward(S)",
            "prompt_tokens": S, **rows_vs(torch, full, torch.stack(steps))}


def teacher_forced_f32_ssd(torch, params, cfg, dev, spawn_key) -> dict:
    """``teacher_forced`` over SSM_F32_SSD_STEPS steps with the chunked SSD
    of prefill and forward computed in float32 (its inputs cast up, its
    outputs back to the compute dtype); decode is as it is. Isolates what
    the bf16 SSD's arithmetic costs (its cumsums of dt A over a chunk
    reach thousands, where bf16's spacing is 16) from the decode path."""
    from repro_torch.models import ssm

    real = ssm.ssd_scan

    def scan(x, dt, A, Bm, Cm, chunk, h0=None):
        y, h = real(x.float(), dt.float(), A.float(), Bm.float(), Cm.float(), chunk,
                    None if h0 is None else h0.float())
        return y.to(x.dtype), h.to(x.dtype)

    ssm.ssd_scan = scan
    try:
        res = teacher_forced(torch, params, cfg, dev, spawn_key, SSM_F32_SSD_STEPS)
    finally:
        ssm.ssd_scan = real
    res["check"] += ", the SSD of prefill and forward in float32"
    return res


def moe_oracle(torch, params, cfg, dev, spawn_key) -> dict:
    """The first layer's MoE input at a FAMILY_SEQ-token prompt, through
    apply_moe and through _local_dispatch_combine(..., 0, E, E) plus the
    shared expert, at the config's capacity factor."""
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm

    batch = lm_batch(torch, M, cfg, 1, FAMILY_SEQ, spawn_key, dev)
    x = M.embed_inputs(params, cfg, batch)
    B, S, d = x.shape
    p = params["blocks"][0]
    ao, _ = tf.attn_forward(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                            M._positions(cfg, B, S, dev), tf.layer_windows(cfg)[0])
    h = rms_norm(x + ao, p["ln2"], cfg.norm_eps).reshape(B * S, d)
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    out, kept = moe.apply_moe(p["moe"], h, k, cf, return_kept=True)
    local, local_kept = moe._local_dispatch_combine(p["moe"], h, k, cf, 0, E, E, return_kept=True)
    if "shared" in p["moe"]:
        local = local + moe._shared(p["moe"]["shared"], h)
    res = {"dtype": str(out.dtype).split(".")[-1], "tokens": B * S, "experts": E, "top_k": k,
           "capacity_factor": cf, "capacity": moe.capacity(B * S, k, E, cf),
           "kept_pairs_equal": bool(torch.equal(kept, local_kept)),
           "kept_assignments": int(kept.sum()),
           "dropped_share": 1.0 - int(kept.sum()) / (B * S * k),
           "max_abs_diff": float((out.float() - local.float()).abs().max()),
           "max_abs_out": float(out.float().abs().max()),
           "finite": bool(torch.isfinite(out).all())}
    del local, local_kept
    res["ep"] = moe_ep_check(torch, p["moe"], h.reshape(B, S, d), cfg, dev, out, kept)
    return res


def moe_ep_check(torch, p, x, cfg, dev, want, want_kept) -> dict:
    """apply_moe_ep over a MOE_EP_MESHES[cfg.name] mesh of the card against
    apply_moe's output ``want`` and kept pairs ``want_kept`` on the same
    tokens (one data shard: the same capacity)."""
    from repro_torch.models import moe
    from repro_torch.train.meshctx import make_mesh

    shape = MOE_EP_MESHES[cfg.name]
    mesh = make_mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, kept = moe.apply_moe_ep(p, x, cfg, mesh, return_kept=True)
    torch.cuda.synchronize()
    return {"mesh": list(shape), "experts_per_shard": cfg.n_experts // shape[1],
            "seconds": time.perf_counter() - t0,
            "kept_pairs_equal": bool(torch.equal(kept, want_kept)),
            "max_abs_diff": float((got.reshape(want.shape).float() - want.float()).abs().max()),
            "max_abs_out": float(want.float().abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def engine_run(torch, cfg, params, prompts, dev) -> dict:
    """The Engine over ``prompts`` (greedy, FAMILY_SERVE_NEW_TOKENS new
    each): the requests, the logits of every step that gave each its next
    token, the slot each took and whether that slot had served a request
    before, the steps and the seconds."""
    from repro_torch.serve.engine import Engine, Request

    eng = Engine(cfg, params, slots=FAMILY_SERVE_SLOTS, cache_len=FAMILY_SERVE_CACHE_LEN,
                 device=dev)
    reqs = [Request(prompt=p, max_new_tokens=FAMILY_SERVE_NEW_TOKENS) for p in prompts]
    for r in reqs:
        eng.submit(r)
    logits = {id(r): [] for r in reqs}
    slot_of, reused, used = {}, {}, set()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.active):
        eng._fill_slots()  # the step fills them too; here to see who sits where
        occupant = list(eng.active)
        n_before = [len(r.out) if r is not None else 0 for r in occupant]
        for s, r in enumerate(occupant):
            if r is not None and id(r) not in slot_of:
                slot_of[id(r)], reused[id(r)] = s, s in used
                used.add(s)
        eng.step()
        for s, r in enumerate(occupant):
            if r is not None and len(r.out) > n_before[s]:
                logits[id(r)].append(eng.last_logits[s].clone())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"reqs": reqs, "logits": [torch.stack(logits[id(r)]) for r in reqs],
            "slots": [slot_of[id(r)] for r in reqs], "reused": [reused[id(r)] for r in reqs],
            "steps": eng.steps_run, "seconds": seconds}


def family_engine_check(torch, params, cfg, dev, spawn_key, bar: float,
                        prefill_bar: float) -> dict:
    """8 requests over 4 slots; the 4 that reuse a slot are held against
    the same requests in a fresh Engine of 4 slots, one fresh slot each (the
    same batch rows, so the same kernels): their logits at every step up to
    the first token where the two runs differ within ``bar``, and where
    they differ the fresh run's top-2 gap within 2 ``bar``. For configs
    that prefill any prompt length (no SSM) and have no vlm front end,
    every request's first-token logits also against prefill(prompt)'s,
    within ``prefill_bar``."""
    from repro_torch.models import model as M

    cfg = no_drop(cfg)
    rng = np.random.default_rng(np.random.SeedSequence(LM_SEED, spawn_key=spawn_key))
    lo, hi = FAMILY_SERVE_PROMPT
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, FAMILY_SERVE_REQUESTS)]
    batched = engine_run(torch, cfg, params, prompts, dev)
    reused = [i for i, r in enumerate(batched["reused"]) if r]
    fresh = engine_run(torch, cfg, params, [prompts[i] for i in reused], dev)
    rows = []
    for i, p in enumerate(prompts):
        got = batched["reqs"][i].out
        row = {"prompt_tokens": len(p), "slot": batched["slots"][i],
               "reused_slot": batched["reused"][i], "new_tokens": len(got)}
        if i in reused:
            j = reused.index(i)
            want = fresh["reqs"][j].out
            n_same = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
            upto = min(n_same + 1, len(got))
            g, w = batched["logits"][i][:upto], fresh["logits"][j][:upto]
            row.update({"fresh_slot_reused": fresh["reused"][j], "tokens_equal_fresh": n_same,
                        "first_token_max_abs_dlogit_vs_fresh": float((g[0] - w[0]).abs().max()),
                        "max_abs_dlogit_vs_fresh": float((g - w).abs().max())})
            if n_same < len(got):
                top2 = torch.topk(w[n_same], 2).values
                row["fresh_top2_gap_at_first_difference"] = float(top2[0] - top2[1])
        if not cfg.has_ssm and cfg.family != "vlm":
            pre, cache = M.prefill(params, cfg, {"tokens": torch.tensor([p], device=dev)})
            del cache
            top2 = torch.topk(pre[0], 2).values
            row.update({"first_token_max_abs_dlogit_vs_prefill":
                        float((batched["logits"][i][0] - pre[0]).abs().max()),
                        "prefill_argmax": int(pre[0].argmax()), "first_token": got[0],
                        "prefill_top2_gap": float(top2[0] - top2[1])})
        rows.append(row)
    held = [r for r in rows if r["reused_slot"]]
    out = {"slots": FAMILY_SERVE_SLOTS, "cache_len": FAMILY_SERVE_CACHE_LEN,
           "requests": FAMILY_SERVE_REQUESTS, "new_tokens": FAMILY_SERVE_NEW_TOKENS,
           "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
           "engine_steps": batched["steps"], "seconds": batched["seconds"],
           "ms_per_step": batched["seconds"] * 1e3 / batched["steps"],
           "generated_tokens_per_s": sum(len(r.out) for r in batched["reqs"]) / batched["seconds"],
           "requests_in_reused_slots": len(held),
           "reused_equal_fresh": sum(r["tokens_equal_fresh"] == r["new_tokens"] for r in held),
           "max_abs_dlogit_vs_fresh": max(r["max_abs_dlogit_vs_fresh"] for r in held),
           "fresh_engine_steps": fresh["steps"], "requests": rows, "bar": bar,
           "prefill_bar": prefill_bar}
    check(len(held) == FAMILY_SERVE_REQUESTS - FAMILY_SERVE_SLOTS,
          f"lm_families {cfg.name} engine: {len(held)} requests reused a slot")
    for i, (r, req) in enumerate(zip(rows, batched["reqs"])):
        check(req.done and r["new_tokens"] == FAMILY_SERVE_NEW_TOKENS,
              f"lm_families {cfg.name} engine: request {i} ended with {r['new_tokens']} tokens")
        if r["reused_slot"]:
            check(not r["fresh_slot_reused"] and r["max_abs_dlogit_vs_fresh"] <= bar,
                  f"lm_families {cfg.name} engine: request {i} in reused slot {r['slot']} vs a "
                  f"fresh slot: max |dlogit| {r['max_abs_dlogit_vs_fresh']}")
            check(r["tokens_equal_fresh"] == r["new_tokens"]
                  or r["fresh_top2_gap_at_first_difference"] <= 2 * bar,
                  f"lm_families {cfg.name} engine: request {i} tokens part from a fresh slot's {r}")
        if "prefill_argmax" in r:
            check(r["first_token_max_abs_dlogit_vs_prefill"] <= prefill_bar,
                  f"lm_families {cfg.name} engine: request {i} first-step logits vs prefill {r}")
            check(r["first_token"] == r["prefill_argmax"]
                  or r["prefill_top2_gap"] <= 2 * prefill_bar,
                  f"lm_families {cfg.name} engine: request {i} first token vs prefill {r}")
    return out


def hold_decode(label: str, res: dict, bar: float) -> None:
    """A decode reading within ``bar``, and no argmax that differs where
    the reference row's top-2 gap exceeds 2 ``bar`` (past that gap no two
    rows within the bar can disagree: SERVE_TIE_GAP's rule)."""
    check(res["finite"], f"{label}: logits not finite")
    check(res["max_abs_dlogit"] <= bar, f"{label}: max |dlogit| {res['max_abs_dlogit']} > {bar}")
    check(res["max_top2_gap_where_argmax_differs"] <= 2 * bar,
          f"{label}: an argmax differs at a top-2 gap of "
          f"{res['max_top2_gap_where_argmax_differs']}, past twice the bar")


def lm_families_phase(torch, dev) -> dict:
    """The other six configs at full width (FAMILY_LAYERS), one at a time:
    the float32 check at 2 layers, then bf16: timed prefill, decode against
    prefill, the MoE layer against its oracle, the Engine."""
    from repro_torch.configs import base as configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    lines = {}
    for arch in FAMILY_LAYERS:
        t_arch = time.perf_counter()
        published = configs.get(arch)
        cfg = published if FAMILY_LAYERS[arch] is None else \
            dataclasses.replace(published, n_layers=FAMILY_LAYERS[arch])
        spawn = (100,) + tuple(arch.encode())  # the config's own seeds
        bf16_before = fa.flash_attention.kernel_launches["bf16"]
        line = {"phase": "lm_families", "arch": arch, "family": cfg.family,
                "layers": cfg.n_layers, "layers_published": published.n_layers,
                "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
                "window": cfg.window, "attention_layers": attention_layers(cfg)}
        part_s = line["part_s"] = {}
        mark = lambda name, t: part_s.__setitem__(name, time.perf_counter() - t)

        # float32, every width, 2 layers (kimi's do not fit)
        if arch != "kimi-k2-1t-a32b":
            cfg32 = dataclasses.replace(cfg, n_layers=FAMILY_F32_LAYERS, param_dtype="float32",
                                        compute_dtype="float32")
            params = M.init_params(cfg32, LM_SEED, dev)
            f32 = family_decode_check(torch, params, cfg32, dev, spawn)
            f32["layers"] = cfg32.n_layers
            line["f32_2_layers"] = f32
            if cfg.n_experts:
                line["moe_oracle_f32"] = moe_oracle(torch, params, cfg32, dev, spawn)
            del params
            torch.cuda.empty_cache()
            mark("f32_2_layers", t_arch)
            hold_decode(f"lm_families {arch} float32", f32, LM_F32_DECODE_ATOL)

        # bf16 at the cut depth
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init_params(cfg, LM_SEED, dev)
        torch.cuda.synchronize()
        line["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["params"] = sum(t.numel() for t in _leaves(params))
        batch = lm_batch(torch, M, cfg, 1, FAMILY_SEQ - cfg.n_patches, spawn, dev)
        times = []
        for _ in range(1 + LM_PREFILL_REPS):  # the first is the warm-up
            torch.cuda.synchronize()
            n0 = fa.flash_attention.kernel_launches["bf16"]
            t0 = time.perf_counter()
            logits, cache = M.prefill(params, cfg, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            n = fa.flash_attention.kernel_launches["bf16"] - n0
            check(n == attention_layers(cfg),
                  f"lm_families {arch}: {n} bf16 flash launches in one prefill")
            del cache
        check(tuple(logits.shape) == (1, cfg.vocab) and bool(torch.isfinite(logits).all()),
              f"lm_families {arch}: last-token logits not finite or of the wrong shape")
        ms = statistics.median(times[1:])
        mark("prefills", t0)
        line.update({"prompt_tokens": FAMILY_SEQ, "patches": cfg.n_patches,
                     "ms_per_prefill": ms, "ms_per_prefill_all": times,
                     "prefill_tokens_per_s": FAMILY_SEQ / (ms / 1e3),
                     "flash_launches_per_prefill": attention_layers(cfg),
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        t0 = time.perf_counter()
        line["prefill_profile"] = device_profile(torch, lambda: M.prefill(params, cfg, batch), 6)
        mark("prefill_profile", t0)
        del batch
        bar = FAMILY_BF16_ATOL[arch]
        t0 = time.perf_counter()
        line["bf16_decode"] = family_decode_check(torch, params, cfg, dev, spawn)
        if cfg.has_ssm:
            line["bf16_decode_f32_ssd"] = teacher_forced_f32_ssd(torch, params, cfg, dev, spawn)
        if cfg.n_experts:
            line["moe_oracle_bf16"] = moe_oracle(torch, params, cfg, dev, spawn)
        mark("bf16_checks", t0)
        t0 = time.perf_counter()
        line["engine"] = family_engine_check(torch, params, cfg, dev, spawn, bar,
                                             FAMILY_ENGINE_PREFILL_ATOL[arch])
        mark("engine", t0)
        del params
        torch.cuda.empty_cache()
        line["bf16_flash_launches"] = fa.flash_attention.kernel_launches["bf16"] - bf16_before
        line["bars"] = {"bf16_max_abs_dlogit": bar, "f32_max_abs_dlogit": LM_F32_DECODE_ATOL,
                        "engine_vs_prefill_max_abs_dlogit": FAMILY_ENGINE_PREFILL_ATOL[arch],
                        "bf16_f32_ssd_max_abs_dlogit": SSM_F32_SSD_ATOL,
                        "moe_oracle_f32_rtol": MOE_ORACLE_RTOL,
                        "moe_ep_f32_rtol": MOE_ORACLE_RTOL, "tie_gap": "2 x the bar"}
        line["phase_s"] = time.perf_counter() - t_arch
        emit(line)
        lines[arch] = line
        hold_decode(f"lm_families {arch} bf16", line["bf16_decode"], bar)
        if "bf16_decode_f32_ssd" in line:
            hold_decode(f"lm_families {arch} bf16, float32 SSD", line["bf16_decode_f32_ssd"],
                        SSM_F32_SSD_ATOL)
        for key in ("moe_oracle_f32", "moe_oracle_bf16"):
            if key in line:
                check(line[key]["kept_pairs_equal"] and line[key]["finite"],
                      f"lm_families {arch} {key}: kept pairs differ {line[key]}")
        if "moe_oracle_f32" in line:
            o = line["moe_oracle_f32"]
            check(o["max_abs_diff"] <= MOE_ORACLE_RTOL * o["max_abs_out"],
                  f"lm_families {arch}: apply_moe vs _local_dispatch_combine {o}")
        for key in ("moe_oracle_f32", "moe_oracle_bf16"):
            if key in line:
                ep = line[key]["ep"]
                check(ep["kept_pairs_equal"] and ep["finite"],
                      f"lm_families {arch} {key}: apply_moe_ep's kept pairs differ {ep}")
                check(key == "moe_oracle_bf16"
                      or ep["max_abs_diff"] <= MOE_ORACLE_RTOL * ep["max_abs_out"],
                      f"lm_families {arch}: apply_moe_ep vs apply_moe {ep}")
    return {"phase": "lm_families", "phase_s": time.perf_counter() - t_phase,
            "archs": list(lines),
            "bf16_flash_launches": {a: ln["bf16_flash_launches"] for a, ln in lines.items()}}


def bwd_errors(got, plain, f32, emu=None) -> dict:
    """For dq, dk and dv: the largest magnitude of the float32 plain
    gradient, the kernel's largest distance from the plain version of its
    own dtype, the kernel's and that plain version's from the float32 one,
    and with ``emu`` (bf16) the kernel's from the emulation of its
    arithmetic and the emulation's from the float32 gradient."""
    out = {}
    for i, (name, g, p, w) in enumerate(zip(("dq", "dk", "dv"), got, plain, f32)):
        out[name] = {"max_abs": float(w.abs().max()),
                     "kernel_vs_plain": float((g.float() - p.float()).abs().max()),
                     "kernel_vs_f32": float((g.float() - w).abs().max()),
                     "plain_vs_f32": float((p.float() - w).abs().max())}
        if emu is not None:
            out[name]["kernel_vs_emulation"] = float((g.float() - emu[i].float()).abs().max())
            out[name]["emulation_vs_f32"] = float((emu[i].float() - w).abs().max())
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude x (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def bwd_bar(dtype: str, e: dict) -> float:
    """A gradient's error over its bar (<= 1 passes): float32, the kernel
    against the plain version at BWD_F32_RTOL_OF_MAX of the largest
    magnitude; bf16, the kernel's distance from the emulation against
    BWD_BF16_EMU_ULPS bf16 ulps of the largest magnitude."""
    if dtype == "float32":
        return e["kernel_vs_plain"] / (BWD_F32_RTOL_OF_MAX * e["max_abs"])
    return e["kernel_vs_emulation"] / (BWD_BF16_EMU_ULPS * bf16_ulp(e["max_abs"]))


def sdpa_bwd_yardstick(torch, q, k, v, do, window: int, f32=None) -> dict:
    """SDPA's backward without the softcap on the same inputs: the time of
    forward plus backward under autograd, less the forward's (the call as
    ``sdpa_yardstick`` makes it: is_causal with enable_gqa for a bf16
    global layer, else the KV heads expanded outside the timed calls, and
    the boolean window mask for a windowed layer). With ``f32`` (the
    float32 plain gradient of the same function), SDPA's gradients'
    distance from it over each one's largest magnitude."""
    import torch.nn.functional as F
    expand = window > 0 or q.dtype != torch.bfloat16
    rep = q.shape[2] // k.shape[2]
    if expand:
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    if window > 0:
        mask = window_mask(torch, q.shape[1], window, q.device)
        fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        name = f"scaled_dot_product_attention(attn_mask=<causal window {window}>)"
    else:
        fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                     enable_gqa=not expand)
        name = f"scaled_dot_product_attention(is_causal=True, enable_gqa={not expand})"
    fwd_bwd = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    f_ms = device_ms(fwd, BWD_TIMING_REPS)
    fb_ms = device_ms(fwd_bwd, BWD_TIMING_REPS)
    out = {"call": "torch.nn.functional." + name + (", KV heads expanded" if expand else "")
                   + ": forward + backward under autograd, less the forward",
           "forward_ms": f_ms, "forward_backward_ms": fb_ms, "library_ms": fb_ms - f_ms}
    if f32 is not None:
        grads = [g.transpose(1, 2) for g in fwd_bwd()]
        if expand:  # the expanded KV heads' gradients summed back over rep
            grads[1:] = [g.unflatten(2, (k.shape[2] // rep, rep)).sum(3) for g in grads[1:]]
        out["vs_f32_of_max"] = {n: float((g.float() - w).abs().max()) / float(w.abs().max())
                                for n, g, w in zip(("dq", "dk", "dv"), grads, f32)}
    return out


def train_kernel_checks(torch, dev) -> dict:
    """Phase train, part 1: the backward kernels against their plain version
    (BWD_SMALL_CASES and BWD_PATH_SHAPES, float32 and bf16; bf16 against
    the emulation of its arithmetic), two launches bit for bit, the
    forward's o with and without its lse bit for bit and its lse against
    the plain one, and at the path shapes the kernel's time, the plain
    version's, the bound and SDPA's backward. Launches made here are not a
    path's."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence(LM_SEED, spawn_key=(22,)).generate_state(1)[0]))
    cases = ([(shape, w, cap, None) for shape, w, cap in BWD_SMALL_CASES]
             + [(shape, w, cap, label) for label, (shape, w, cap) in BWD_PATH_SHAPES.items()])
    small, path = {"float32": [], "bfloat16": []}, {}
    for shape, window, cap, label in cases:
        B, S, H, G, hd = shape
        master = [torch.randn(s, generator=gen, device=dev)
                  for s in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd), (B, S, H, hd))]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v, do = (t.to(dtype) for t in master)
            fwd = lambda **kw: ops.flash_attention(q, k, v, window=window, softcap=cap, **kw)
            o = fwd()
            want_lse = ref.flash_attention_ref(q, k, v, window=window, softcap=cap,
                                               return_lse=True)[1]
            fwd_row = lse_checks(torch, f"train forward {name} {shape} window={window} "
                                        f"softcap={cap}", o, fwd, want_lse)
            del want_lse
            _, lse = fwd(return_lse=True)
            run = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, window=window,
                                                  softcap=cap)
            plain = lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window,
                                                        softcap=cap)
            got, again = run(), run()
            torch.cuda.synchronize()
            want = plain()
            bf16 = dtype == torch.bfloat16
            f32 = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                              window=window, softcap=cap) if bf16 else want
            emu = ref.flash_attention_bwd_emulation(q, k, v, o, lse, do, window=window,
                                                    softcap=cap) if bf16 else None
            row = {"B_S_H_G_hd": shape, "window": window, "softcap": cap, **fwd_row,
                   "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
                   **bwd_errors(got, want, f32, emu)}
            del got, again, want, emu
            row["max_err_over_bar"] = max(bwd_bar(name, row[g]) for g in ("dq", "dk", "dv"))
            check(row["bitwise_repeat"], f"flash backward {name} {shape}: two launches differ")
            check(row["max_err_over_bar"] <= 1.0,
                  f"flash backward {name} {shape} window={window} softcap={cap}: {row}")
            if label is None:
                small[name].append(row)
                del f32
                continue
            t_b, by = rl.flash_bwd_bound(B, S, H, G, hd, window, q.element_size(),
                                         rl.PEAK_FLOPS if bf16 else rl.FP32_FLOPS)
            row.update({"dtype": name, "ms": device_ms(run, BWD_TIMING_REPS),
                        "plain_ms": device_ms(plain, BWD_PLAIN_TIMING_REPS),
                        "bound_ms": t_b, "bound_by": by, "pairs": rl.flash_pairs(S, window)})
            if not bf16:  # the seven products at the float32 FMA rate
                row["ffma7_ms"] = rl.flash_bwd_bound(B, S, H, G, hd, window, 4, rl.FP32_FLOPS,
                                                     KERNEL_BWD_PRODUCTS)[0]
            if cap is not None:  # the kernel on the library call's function
                o_nc, lse_nc = ops.flash_attention(q, k, v, window=window, return_lse=True)
                row["kernel_without_softcap_ms"] = device_ms(
                    lambda: ops.flash_attention_bwd(q, k, v, o_nc, lse_nc, do, window=window),
                    BWD_TIMING_REPS)
                del o_nc, lse_nc
            # SDPA's own bf16 distance from the float32 gradient, beside the
            # emulation's, where it computes the same function (no softcap)
            row["library"] = sdpa_bwd_yardstick(torch, q, k, v, do, window,
                                                f32 if bf16 and cap is None else None)
            row["library_ms"] = row["library"]["library_ms"]
            if "vs_f32_of_max" in row["library"]:
                row["emulation_vs_f32_of_max"] = {
                    g: row[g]["emulation_vs_f32"] / row[g]["max_abs"] for g in ("dq", "dk", "dv")}
            path[f"{label}_{name}"] = row
            del q, k, v, do, o, lse, f32
            torch.cuda.empty_cache()
        del master
        torch.cuda.empty_cache()
    return {"phase": "train", "part": "kernels", "phase_s": time.perf_counter() - t_phase,
            "small": small, "path": path,
            "bars": {"float32_rtol_of_max": BWD_F32_RTOL_OF_MAX,
                     "bf16": f"|kernel - emulation| <= {BWD_BF16_EMU_ULPS} bf16 ulps of "
                             f"max|f32 plain|",
                     "lse_rtol": FLASH_LSE_RTOL},
            "timing": f"device time, median of {BWD_TIMING_REPS} calls between CUDA events "
                      f"({BWD_PLAIN_TIMING_REPS} for the plain version)"}


@contextlib.contextmanager
def plain_attention_pair(ops, ref):
    """The plain attention and its plain gradient in the kernels' places
    (``models.attention`` reaches both through ``kernels.ops``)."""
    real = ops.flash_attention, ops.flash_attention_bwd
    ops.flash_attention = lambda q, k, v, *, window=None, softcap=None, return_lse=False: \
        ref.flash_attention_ref(q, k, v, window=window, softcap=softcap, return_lse=return_lse)
    ops.flash_attention_bwd = lambda q, k, v, o, lse, do, *, window=None, softcap=None: \
        ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window, softcap=softcap)
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_attention_bwd = real


def named_leaves(tree, prefix: str = "") -> dict:
    """{key path: tensor} of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {n: t for k in sorted(tree) for n, t in named_leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {n: t for i, x in enumerate(tree) for n, t in named_leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def train_slice_check(torch, dev) -> dict:
    """Phase train, part 2: stablelm-3b at full width, TRAIN_SLICE_LAYERS
    layers, one loss and backward through the kernels against the same
    through the plain attention pair, in float32 and in bf16."""
    from repro_torch.configs import base as configs
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.train_step import value_and_grad

    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=TRAIN_SLICE_LAYERS)
    cfg32 = dataclasses.replace(cfg16, param_dtype="float32", compute_dtype="float32")
    batch = batch_at(DataConfig(vocab=cfg16.vocab, global_batch=1, seq_len=TRAIN_SLICE_TOKENS),
                     0, dev)

    def run(params, cfg, plain: bool):
        with plain_attention_pair(ops, ref) if plain else contextlib.nullcontext():
            loss, grads = value_and_grad(params, cfg, batch)
        return float(loss), named_leaves(grads)

    params = M.init_params(cfg32, LM_SEED, dev)
    loss_k, g_k = run(params, cfg32, False)
    loss_p, g_p = run(params, cfg32, True)
    err = {n: float((g_k[n] - g_p[n]).abs().max()) / max(float(g_p[n].abs().max()), 1e-30)
           for n in g_p}
    attn_grads = {n: float(g_k[n].abs().max()) for n in g_k
                  if n.split("/")[-1] in ("wq", "wk", "wv")}
    f32 = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "worst_leaf": max(err, key=err.get), "worst_grad_err_of_max": max(err.values()),
           "attn_qkv_grad_max_abs": attn_grads}
    del g_k, g_p
    # bf16: the same parameters rounded, against the float32 plain gradient
    # of the rounded values
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    loss16_k, g16_k = run(p16, cfg16, False)
    loss16_p, g16_p = run(p16, cfg16, True)
    loss_up, g_up = run(tree_map(lambda t: t.float(), p16), cfg32, True)
    over = {}
    for n, w in g_up.items():
        mx = float(w.abs().max())
        d_k = float((g16_k[n].float() - w).abs().max())
        d_p = float((g16_p[n].float() - w).abs().max())
        over[n] = d_k / (BWD_BF16_PLAIN_FACTOR * d_p + BWD_BF16_RTOL_OF_MAX * mx)
    bf16 = {"loss_kernels": loss16_k, "loss_plain": loss16_p, "loss_f32_plain": loss_up,
            "worst_leaf": max(over, key=over.get), "max_err_over_bar": max(over.values()),
            "attn_qkv_grad_max_abs": {n: float(g16_k[n].float().abs().max()) for n in g16_k
                                      if n.split("/")[-1] in ("wq", "wk", "wv")}}
    del g16_k, g16_p, g_up, p16
    torch.cuda.empty_cache()
    line = {"phase": "train", "part": "slice", "arch": TRAIN_ARCH, "layers": TRAIN_SLICE_LAYERS,
            "tokens": TRAIN_SLICE_TOKENS, "float32": f32, "bf16": bf16,
            "bars": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol_of_max": TRAIN_GRAD_RTOL_OF_MAX,
                     "bf16": f"per leaf, |kernels - f32 plain| <= {BWD_BF16_PLAIN_FACTOR} "
                             f"|bf16 plain - f32 plain| + {BWD_BF16_RTOL_OF_MAX} max"},
            "phase_s": time.perf_counter() - t0}
    emit(line)
    check(f32["loss_rel_err"] <= TRAIN_LOSS_RTOL, f"train slice float32 loss: {f32}")
    check(f32["worst_grad_err_of_max"] <= TRAIN_GRAD_RTOL_OF_MAX,
          f"train slice float32 gradient: {f32['worst_leaf']} {f32['worst_grad_err_of_max']}")
    check(bf16["max_err_over_bar"] <= 1.0,
          f"train slice bf16 gradient: {bf16['worst_leaf']} {bf16['max_err_over_bar']}")
    for part in (f32, bf16):
        check(len(part["attn_qkv_grad_max_abs"]) == 3 * TRAIN_SLICE_LAYERS
              and all(0 < g < float("inf") for g in part["attn_qkv_grad_max_abs"].values()),
              f"train slice: wq, wk or wv got no gradient: {part['attn_qkv_grad_max_abs']}")
    return line


def train_step_profile(torch, fn) -> dict:
    """Run one train step ``fn`` under torch.profiler: its wall time, the
    device time of its kernels, the card's idle share, and the device time
    and share of the flash kernels (forward, and the three backward
    kernels, whose names hold "flash_bwd")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy = sum(t for t, _, _ in kernels)
    bwd = sum(t for t, _, key in kernels if "flash_bwd" in key)
    fwd = sum(t for t, _, key in kernels if "flash_attention_" in key and "kernel" in key)
    kernels.sort(reverse=True)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if busy else None,
            "flash_bwd_ms": bwd / 1e3, "flash_bwd_share_of_step": bwd / wall_us,
            "flash_bwd_share_of_device": bwd / busy if busy else None,
            "flash_fwd_ms": fwd / 1e3,
            "top_kernels_ms": [(k[:60], n, t / 1e3) for t, n, k in kernels[:8]]}


def dryrun_prediction(label: str, cfg, shape, held_bytes: int, peak_bytes: int) -> dict:
    """launch/dryrun.py's record of (cfg, shape) on a 1-position mesh
    against the card: its argument bytes by part beside ``held_bytes``
    (the parameters, and optimizer state, the card holds), its predicted
    peak (arguments + temporaries) over the measured ``peak_bytes`` with
    the bar DRYRUN_PEAK_RATIO_BARS[label]. Allocates nothing on the
    card."""
    from repro_torch.launch import dryrun
    from repro_torch.train.meshctx import make_mesh

    t0 = time.perf_counter()
    rec = dryrun.run_cell(cfg, shape, mesh=make_mesh((1, 1), ("data", "model"), ["meta"]))
    seconds = ADDED_SECONDS[label] = time.perf_counter() - t0
    mem = rec["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    parts = rec["argument_parts"]
    return {"cell": [cfg.name, shape.kind, shape.global_batch, shape.seq_len],
            "argument_parts": parts, "held_bytes": held_bytes,
            "held_equal": parts["params"] + parts.get("opt_state", 0) == held_bytes,
            "memory": mem, "predicted_peak_gb": predicted / 1e9,
            "measured_peak_gb": peak_bytes / 1e9, "peak_ratio": predicted / peak_bytes,
            "bar": DRYRUN_PEAK_RATIO_BARS[label], "flops": rec["cost"]["flops"],
            "seconds": seconds}


def hold_prediction(label: str, pred: dict) -> None:
    """Raise unless ``dryrun_prediction``'s bytes equal the held ones and
    its peak ratio lies within its bar."""
    lo, hi = pred["bar"]
    check(pred["held_equal"], f"{label} dry run: argument bytes {pred['argument_parts']} vs "
                              f"{pred['held_bytes']} held on the card")
    check(lo <= pred["peak_ratio"] <= hi,
          f"{label} dry run: predicted peak {pred['predicted_peak_gb']} GB over measured "
          f"{pred['measured_peak_gb']} GB is {pred['peak_ratio']}, outside {pred['bar']}")


def train_full(torch, dev) -> dict:
    """Phase train, part 3: stablelm-3b at full width and depth in bf16,
    trained through launch/train.py's ``build`` and the Trainer:
    TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens, then one more step under the profiler."""
    from repro_torch.configs import base as configs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_cli
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    published = configs.get(TRAIN_ARCH)
    counts = lambda: (fa.flash_attention.kernel_launches["bf16"], fa.flash_attention_bwd.launches,
                      fa.flash_attention_bwd.kernel_launches["bf16"])
    with tempfile.TemporaryDirectory(prefix="repro-torch-train-") as ckpt_dir:
        args = train_cli.parser().parse_args(
            ["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch", str(TRAIN_BATCH),
             "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir, "--ckpt-every", str(steps + 1)])
        cfg, opt, data, tc = train_cli.build(args)
        check(cfg == published, f"the CLI's config is not {TRAIN_ARCH}'s: {cfg}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, opt, data, tc, device=args.device)
        rows, last = [], [counts()]

        def on_step(step, loss, dt, slow):
            now = counts()
            rows.append({"step": step, "loss": loss, "ms": dt * 1e3,
                         "fwd_launches": now[0] - last[0][0], "bwd_calls": now[1] - last[0][1],
                         "bwd_kernel_launches": now[2] - last[0][2]})
            last[0] = now

        t0 = time.perf_counter()
        out = trainer.run(hooks={"on_step": on_step})
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        written = sorted(os.listdir(ckpt_dir))
        state = out["state"]
        n_params = sum(t.numel() for t in _leaves(state["params"]))
        held = sum(t.nbytes for t in _leaves([state["params"], state["opt"]]))
        pred = dryrun_prediction("train", cfg, ShapeConfig("trainer", TRAIN_SEQ, TRAIN_BATCH,
                                                           "train"), held, peak)
        batch = batch_at(data, steps, trainer.device)
        profile_ = train_step_profile(
            torch, lambda: trainer.step_fn(state["params"], state["opt"], batch))
        params = state["params"]
        del out, state, batch, trainer  # the optimizer moments go with the state
    torch.cuda.empty_cache()
    mesh_line = train_mesh_check(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    timed = [r["ms"] for r in rows[TRAIN_WARMUP_STEPS:]]
    ms = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    line = {"phase": "train", "part": "full", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
            "params": n_params, "dtype": cfg.param_dtype, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "lr": opt.lr, "warmup_steps": opt.warmup_steps,
            "remat": [cfg.remat, cfg.remat_policy], "steps": rows,
            "ms_per_step": ms, "ms_per_step_timed": timed, "tokens_per_s": tokens / (ms / 1e3),
            "peak_memory_gb": peak / 1e9, "checkpoints_written": written,
            "profile": profile_, "run_s": run_s, "phase_s": time.perf_counter() - t_phase,
            "mesh_s": mesh_line["phase_s"], "dryrun": pred}
    emit(line)
    line["mesh"] = mesh_line
    check(len(rows) == steps and all(np.isfinite(r["loss"]) for r in rows),
          f"train full: losses {[r['loss'] for r in rows]}")
    layers = published.n_layers
    for r in rows:
        check(r["fwd_launches"] == 2 * layers and r["bwd_calls"] == layers
              and r["bwd_kernel_launches"] == layers * len(fa.BWD_KERNELS["bf16"]),
              f"train full: step {r['step']} launched {r}")
    check(peak < TRAIN_PEAK_BYTES, f"train full: peak memory {peak / 1e9:.1f} GB")
    hold_prediction("train", pred)
    check(not written, f"train full: checkpoints written: {written}")
    check(n_params == sum(t.numel() for t in _leaves(M.param_shapes(published))),
          f"train full: {n_params} parameters trained")
    return line


def _timed(torch, fn, reps: int = MESH_TIMING_REPS):
    """fn's result and its median host time to completion on the card, ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _grad_run(torch, forward, leaves: dict):
    """forward()'s output and the gradient of sum(out^2) (in float32) with
    respect to ``leaves`` {name: tensor}, with the forward's and the
    backward's host times to completion, ms."""
    for t in leaves.values():
        t.grad = None
        t.requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {n: t.grad for n, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    return out.detach(), grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _leaf_errors(got: dict, want: dict, unit) -> dict:
    """Per leaf: max |got - want| in units of ``unit(max |want|)``."""
    return {n: float((got[n].float() - w.float()).abs().max())
            / max(unit(float(w.float().abs().max())), 1e-30) for n, w in want.items()}


def train_mesh_check(torch, dev, cfg, params) -> dict:
    """Phase train, part "mesh" (the multi-device modules on one card; the
    constants' comment): the pipeline in bf16 at full depth and in float32
    at 4 layers, apply_mlp_ep, reshard and rescale_checkpoint."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import base as configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import elastic
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models import pipeline as pp
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import swiglu_apply
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import sharding as shd
    from repro_torch.train.meshctx import make_mesh

    t_phase = time.perf_counter()
    counts = lambda: {"flash_attention_bf16": fa.flash_attention.kernel_launches["bf16"],
                      "flash_attention_f32": fa.flash_attention.kernel_launches["float32"],
                      "flash_attention_bwd_bf16": fa.flash_attention_bwd.kernel_launches["bf16"],
                      "flash_attention_bwd_f32": fa.flash_attention_bwd.kernel_launches["float32"]}
    before = counts()
    line = {"phase": "train", "part": "mesh", "arch": cfg.name, "part_s": {}}
    mark = lambda name, t: line["part_s"].__setitem__(name, time.perf_counter() - t)
    stages = make_mesh((MESH_PIPE_STAGES,), ("model",), [dev] * MESH_PIPE_STAGES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    cfg = dataclasses.replace(cfg, remat=False)  # GPipe keeps its activations

    # (a) bf16, every layer
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    B, S = MESH_PIPE_TOKENS
    Bm = B // MESH_PIPE_MICRO
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, device=dev).expand(B, S)
    blocks = [tree_map(lambda t: t.detach(), b) for b in params["blocks"]]
    run_pipe = lambda: pp.pipeline_forward(blocks, cfg, x, pos, stages, MESH_PIPE_MICRO)
    run_micro = lambda: torch.cat([tf.stack_forward(blocks, cfg, xm, pos[:Bm])
                                   for xm in x.split(Bm)])
    with torch.no_grad():
        fwd, fwd_ms = _timed(torch, run_pipe)
        micro, micro_ms = _timed(torch, run_micro)
        whole, whole_ms = _timed(torch, lambda: tf.stack_forward(blocks, cfg, x, pos))
    leaves = named_leaves(blocks)
    _grad_run(torch, run_pipe, leaves)  # warm-up: autograd's first pass at these shapes
    n0 = (fa.flash_attention.kernel_launches["bf16"], fa.flash_attention_bwd.launches,
          fa.flash_attention_bwd.kernel_launches["bf16"])
    out, g_pipe, pipe_fwd_ms, pipe_bwd_ms = _grad_run(torch, run_pipe, leaves)
    launches = {"forward": fa.flash_attention.kernel_launches["bf16"] - n0[0],
                "backward_calls": fa.flash_attention_bwd.launches - n0[1],
                "backward_kernels": fa.flash_attention_bwd.kernel_launches["bf16"] - n0[2]}
    _, g_micro, micro_fwd_ms, micro_bwd_ms = _grad_run(torch, run_micro, leaves)
    ulps = _leaf_errors(g_pipe, g_micro, bf16_ulp)
    del g_micro
    _, g_whole, whole_fwd_ms, whole_bwd_ms = _grad_run(
        torch, lambda: tf.stack_forward(blocks, cfg, x, pos), leaves)
    ulps_whole = _leaf_errors(g_pipe, g_whole, bf16_ulp)
    del g_whole
    qkv = {n: float(g.float().abs().max()) for n, g in g_pipe.items()
           if n.split("/")[-1] in ("wq", "wk", "wv")}
    line["bf16"] = {
        "layers": cfg.n_layers, "stages": MESH_PIPE_STAGES, "microbatches": MESH_PIPE_MICRO,
        "tokens": [B, S], "forward_equal_microbatched": bool(torch.equal(fwd, micro)),
        "grad_run_forward_equal": bool(torch.equal(out, micro)),
        "max_abs_diff_vs_whole_batch": float((fwd.float() - whole.float()).abs().max()),
        "max_abs_out": float(whole.float().abs().max()),
        "worst_leaf": max(ulps, key=ulps.get), "worst_grad_bf16_ulps_of_max": max(ulps.values()),
        "worst_grad_bf16_ulps_of_max_vs_whole_batch": max(ulps_whole.values()),
        "qkv_grads": len(qkv), "qkv_grad_min_of_max_abs": min(qkv.values()),
        "flash_launches": launches, "ms": {
            "pipeline_forward": fwd_ms, "microbatched_forward": micro_ms,
            "whole_batch_forward": whole_ms, "pipeline_grad_forward": pipe_fwd_ms,
            "pipeline_backward": pipe_bwd_ms, "microbatched_grad_forward": micro_fwd_ms,
            "microbatched_backward": micro_bwd_ms, "whole_batch_grad_forward": whole_fwd_ms,
            "whole_batch_backward": whole_bwd_ms},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del x, fwd, micro, whole, out, g_pipe, leaves
    torch.cuda.empty_cache()
    mark("pipeline_bf16", t0)

    # (b) float32, the first layers
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, n_layers=MESH_PIPE_F32_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    blocks32 = [tree_map(lambda t: t.float(), b) for b in blocks[:MESH_PIPE_F32_LAYERS]]
    B, S = MESH_PIPE_F32_TOKENS
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(S, device=dev).expand(B, S)
    leaves = named_leaves(blocks32)
    n0 = fa.flash_attention.kernel_launches["float32"], fa.flash_attention_bwd.launches
    got, g_got, _, _ = _grad_run(
        torch, lambda: pp.pipeline_forward(blocks32, cfg32, x, pos, stages, MESH_PIPE_F32_MICRO),
        leaves)
    f32_launches = {"forward": fa.flash_attention.kernel_launches["float32"] - n0[0],
                    "backward_calls": fa.flash_attention_bwd.launches - n0[1]}
    want, g_want, _, _ = _grad_run(torch, lambda: tf.stack_forward(blocks32, cfg32, x, pos), leaves)
    errs = _leaf_errors(g_got, g_want, lambda m: m)
    line["float32"] = {
        "layers": MESH_PIPE_F32_LAYERS, "stages": MESH_PIPE_STAGES,
        "microbatches": MESH_PIPE_F32_MICRO, "tokens": [B, S],
        "out_err_of_max": float((got - want).abs().max() / want.abs().max()),
        "worst_leaf": max(errs, key=errs.get), "worst_grad_err_of_max": max(errs.values()),
        "flash_launches": f32_launches}
    del blocks32, x, got, want, g_got, g_want, leaves
    mark("pipeline_f32", t0)

    # (c) apply_mlp_ep, float32
    t0 = time.perf_counter()
    mlp = {k: t.float() for k, t in blocks[0]["mlp"].items()}
    x = torch.randn((1, MESH_MLP_TOKENS, cfg.d_model), generator=gen, device=dev)
    tp = make_mesh((1, MESH_MLP_TP), ("data", "model"), [dev] * MESH_MLP_TP)
    got, ep_ms = _timed(torch, lambda: moe.apply_mlp_ep(mlp, x, cfg, tp))
    want, plain_ms = _timed(torch, lambda: swiglu_apply(mlp, x))
    line["mlp_ep"] = {"tp": MESH_MLP_TP, "d_ff": cfg.d_ff, "d_ff_per_shard": cfg.d_ff // MESH_MLP_TP,
                      "tokens": MESH_MLP_TOKENS,
                      "err_of_max": float((got - want).abs().max() / want.abs().max()),
                      "ms": ep_ms, "swiglu_apply_ms": plain_ms}
    del mlp, x, got, want
    torch.cuda.empty_cache()
    mark("mlp_ep", t0)

    # (d) reshard and rescale_checkpoint: the reduced config's parameters
    t0 = time.perf_counter()
    small = M.init_params(configs.reduced(configs.get(TRAIN_ARCH)), LM_SEED, dev)
    meshes = [make_mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))
              for shape in (MESH_RESHARD_FROM, MESH_RESHARD_TO)]
    with tempfile.TemporaryDirectory(prefix="repro-torch-elastic-") as d:
        ckpt.save_checkpoint(d, elastic.reshard(small, meshes[0]), 1)
        placed = elastic.rescale_checkpoint(d, 1, small, meshes[1])
    back = named_leaves(elastic.gather(placed))
    placed = named_leaves(placed)
    want = named_leaves(small)
    shards = [(t, s.sharding.shard_shape(s.shape)) for s in placed.values()
              for t in s.shards.values()]
    line["reshard"] = {
        "from": list(MESH_RESHARD_FROM), "to": list(MESH_RESHARD_TO), "leaves": len(want),
        "shards": len(shards),
        "leaves_equal": sum(back[n].dtype == w.dtype and bool(torch.equal(back[n], w))
                            for n, w in want.items()),
        "shard_shapes_ok": all(tuple(t.shape) == sh for t, sh in shards),
        "shards_on_card": all(t.device.type == "cuda" for t, _ in shards),
        "specs": {n: list(s.sharding.spec) for n, s in list(placed.items())[:4]}}
    del small, placed, back, shards
    mark("reshard", t0)
    line["launches"] = {k: n - before[k] for k, n in counts().items()}
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)

    a, b, c, r = line["bf16"], line["float32"], line["mlp_ep"], line["reshard"]
    L, n_micro = cfg.n_layers, MESH_PIPE_MICRO
    check(a["forward_equal_microbatched"] and a["grad_run_forward_equal"],
          f"train mesh: the bf16 pipeline is not stack_forward over its microbatches: {a}")
    check(a["worst_grad_bf16_ulps_of_max"] <= MESH_PIPE_BF16_ULPS,
          f"train mesh: bf16 pipeline gradient {a['worst_leaf']} {a['worst_grad_bf16_ulps_of_max']}")
    check(a["qkv_grads"] == 3 * L and 0 < a["qkv_grad_min_of_max_abs"] < float("inf"),
          f"train mesh: wq, wk or wv got no gradient: {a}")
    check(a["flash_launches"] == {"forward": L * n_micro, "backward_calls": L * n_micro,
                                  "backward_kernels": L * n_micro * len(fa.BWD_KERNELS["bf16"])},
          f"train mesh: the bf16 pipeline launched {a['flash_launches']}")
    check(a["peak_memory_gb"] < TRAIN_PEAK_BYTES / 1e9, f"train mesh: peak {a['peak_memory_gb']} GB")
    check(b["out_err_of_max"] <= MESH_F32_RTOL_OF_MAX
          and b["worst_grad_err_of_max"] <= TRAIN_GRAD_RTOL_OF_MAX,
          f"train mesh: float32 pipeline vs stack_forward {b}")
    check(b["flash_launches"] == {"forward": MESH_PIPE_F32_LAYERS * MESH_PIPE_F32_MICRO,
                                  "backward_calls": MESH_PIPE_F32_LAYERS * MESH_PIPE_F32_MICRO},
          f"train mesh: float32 flash launches {b['flash_launches']}")
    check(c["err_of_max"] <= MESH_F32_RTOL_OF_MAX, f"train mesh: apply_mlp_ep vs swiglu_apply {c}")
    check(r["leaves_equal"] == r["leaves"] and r["shard_shapes_ok"] and r["shards_on_card"],
          f"train mesh: reshard / rescale_checkpoint {r}")
    return line


def train_reduced_check(torch, dev) -> dict:
    """Phase train, part 4: every family's reduced config, one loss and
    gradient on the card against the same on the CPU; the Trainer's
    restart on the card, bit for bit; 25 steps with compressed gradients."""
    from repro_torch.configs import base as configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    archs = {}
    B, S = TRAIN_REDUCED_TOKENS
    for arch in TRAIN_REDUCED_ARCHS:
        cfg = configs.reduced(configs.get(arch))
        params_cpu = M.init_params(cfg, LM_SEED, "cpu")
        rng = np.random.default_rng(np.random.SeedSequence(
            LM_SEED, spawn_key=(200,) + tuple(arch.encode())))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
        batch_cpu = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            batch_cpu["patch_embeds"] = torch.from_numpy(
                rng.standard_normal((B, cfg.n_patches, M.PATCH_DIM), dtype=np.float32))
        loss_c, g_c = value_and_grad(params_cpu, cfg, batch_cpu)
        loss_g, g_g = value_and_grad(to_device(params_cpu, dev), cfg, to_device(batch_cpu, dev))
        g_c, g_g = named_leaves(g_c), named_leaves(g_g)
        err = {n: float((g_g[n].cpu() - g_c[n]).abs().max()) / max(float(g_c[n].abs().max()),
                                                                     1e-30) for n in g_c}
        archs[arch] = {"loss_card": float(loss_g), "loss_cpu": float(loss_c),
                       "loss_rel_err": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
                       "worst_leaf": max(err, key=err.get), "worst_grad_err_of_max": max(err.values())}
    # the Trainer's restart on the card (tests/test_substrate.py:92's twin)
    cfg = configs.reduced(configs.get(TRAIN_ARCH))
    data = DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=S, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    with tempfile.TemporaryDirectory(prefix="repro-torch-restart-") as d:
        tc = lambda name: TrainConfig(steps=TRAIN_RESTART_STEPS, ckpt_dir=os.path.join(d, name),
                                      ckpt_every=TRAIN_RESTART_EVERY)
        uninterrupted = Trainer(cfg, opt, data, tc("ref"), device=dev).run()
        failed = None
        try:
            Trainer(cfg, opt, data, tc("ft"), device=dev).run(
                hooks={"inject_failure": lambda s: s == TRAIN_RESTART_FAIL_AT})
        except RuntimeError as e:
            failed = str(e)
        resumed = Trainer(cfg, opt, data, tc("ft"), device=dev).run()
    restart = {"injected": failed, "resumed_steps": len(resumed["losses"]),
               "losses_equal": resumed["losses"][-3:] == uninterrupted["losses"][-3:],
               "state_equal": all(torch.equal(a, b) for a, b in zip(
                   tree_leaves(uninterrupted["state"]), tree_leaves(resumed["state"]))),
               "losses": uninterrupted["losses"]}
    # compressed gradients (tests/test_substrate.py:143's twin)
    with tempfile.TemporaryDirectory(prefix="repro-torch-compress-") as d:
        comp = Trainer(cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40),
                       DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16, seed=0),
                       TrainConfig(steps=TRAIN_COMPRESS_STEPS, ckpt_dir=d, ckpt_every=100,
                                   compress_grads=True), device=dev).run()
    compress = {"first5_mean": float(np.mean(comp["losses"][:5])),
                "last5_mean": float(np.mean(comp["losses"][-5:]))}
    line = {"phase": "train", "part": "reduced", "tokens": [B, S], "archs": archs,
            "restart": restart, "compress": compress, "phase_s": time.perf_counter() - t_phase}
    emit(line)
    for arch, r in archs.items():
        check(r["loss_rel_err"] <= TRAIN_LOSS_RTOL
              and r["worst_grad_err_of_max"] <= TRAIN_GRAD_RTOL_OF_MAX,
              f"train reduced {arch}: card vs CPU {r}")
    check(failed is not None and "injected failure" in failed,
          f"train restart: the injected failure did not stop the run: {failed}")
    check(restart["resumed_steps"] == TRAIN_RESTART_STEPS - TRAIN_RESTART_EVERY
          and restart["losses_equal"] and restart["state_equal"],
          f"train restart on the card is not bit for bit: {restart}")
    check(compress["last5_mean"] < compress["first5_mean"],
          f"train with compressed gradients did not converge: {compress}")
    return line


def unpack_events(blob: str, shape) -> np.ndarray:
    """A (T, L) bool record from packed bits, zlib, base64."""
    bits = np.frombuffer(zlib.decompress(base64.b64decode(blob)), np.uint8)
    return np.unpackbits(bits)[:int(np.prod(shape))].reshape(shape).astype(bool)


def first_event_diff(tr, record: dict):
    """The first slot at which the card's admitted or departed record leaves
    the reference's, or None."""
    first = None
    for f in ("admitted", "departed"):
        got = getattr(tr, f).cpu().numpy()
        bad = np.nonzero((unpack_events(record[f], got.shape) != got).any(-1))[0]
        if bad.size:
            first = int(bad[0]) if first is None else min(first, int(bad[0]))
    return first


def metric_error(got: float, want: float, scale: float = 1.0) -> float:
    """|got - want| / max(|want|, scale); 0 when both are NaN or equal, inf
    when one is NaN."""
    if np.isnan(want) or np.isnan(got):
        return 0.0 if np.isnan(want) and np.isnan(got) else float("inf")
    if got == want:
        return 0.0
    return abs(got - want) / max(abs(want), scale)


def hold_metrics(label: str, got: dict, want: dict, bars: dict, scales=None) -> dict:
    """Each metric of ``want`` against ``got`` at its bar (``bars`` by
    metric, "*" for the rest), the error relative to max(|want|, scale)
    with ``scales`` by metric (1 for the rest); returns the errors."""
    scales = scales or {}
    errs = {k: metric_error(got[k], w, scales.get(k, 1.0)) for k, w in want.items()}
    for k, e in errs.items():
        bar = bars.get(k, bars["*"])
        check(e <= bar, f"{label} {k}: {got[k]} vs reference {want[k]} (error {e}, bar {bar})")
    return errs


def capacity_excess(tr, spec, faults) -> float:
    """max over slots of used - (c_t (1 + FEAS_TOL) + FEAS_TOL), c_t the
    slot's surviving capacity: at most 0 when every slot is feasible."""
    from repro_torch.sched import lifecycle
    c_t = spec.c[None] if faults is None else spec.c[None] * faults[:, None, :]
    return float((tr.used - (c_t * (1.0 + lifecycle.FEAS_TOL) + lifecycle.FEAS_TOL)).max())


def launch_snapshot():
    """The sortscan kernels' launch counts by packed shape, as plain dicts."""
    from repro_torch.kernels import oga_step, sortscan
    return {"oga_step_fused": dict(oga_step.oga_step_fused.launches_by_shape),
            "proj_sortscan": dict(sortscan.proj_sortscan.launches_by_shape)}


def launch_delta(before: dict, after: dict) -> dict:
    """Launches by kernel and shape between two snapshots ("NxL": n)."""
    return {k: {f"{N}x{L}": n - before[k].get((N, L), 0)
                for (N, L), n in sorted(after[k].items()) if n - before[k].get((N, L), 0)}
            for k in after}


def expected_launches(name: str, T: int, N: int, L: int) -> dict:
    """One fused step and one projection a OGASCHED slot; one projection a
    slot for a heuristic's allocation; the fluid solve's FLUID_ITERS a slot
    (plus the allocation for MULTICLASS; heSRPT's solve is its allocation)."""
    shape = f"{N}x{L}"
    proj = {"ogasched": T, "multiclass": (FLUID_ITERS + 1) * T, "hesrpt": FLUID_ITERS * T}
    return {"oga_step_fused": {shape: T} if name == "ogasched" else {},
            "proj_sortscan": {shape: proj.get(name, T)}}


def lifecycle_phase(torch, dev, beside=None) -> dict:
    """benchmarks/bench_lifecycle.py's configuration through lifecycle.run
    for every algorithm, held to the reference's readings. ``beside``, when
    given, is called after the six runs and before the duration-1 check
    and the slot profile: the faults phase's workers run beside the six
    runs, and are collected there, so the profile runs alone."""
    from repro_torch.core import ogasched
    from repro_torch.sched import lifecycle, trace

    t_phase = time.perf_counter()
    cfg = trace.TraceConfig(**LIFECYCLE_CFG)
    spec, arr, works = trace.make_lifecycle(cfg)
    with open(os.path.join(ROOT, LIFECYCLE_EVENTS)) as f:
        records = json.load(f)["lifecycle"]["records"]
    N, L = cfg.R * cfg.K, cfg.L
    rows = {}
    for name in LIFECYCLE_ALGORITHMS:
        before = launch_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = lifecycle.run(spec, arr, works, name)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6 / cfg.T
        launched = launch_delta(before, launch_snapshot())
        summary = lifecycle.summarize(tr, spec)
        got = {"avg_reward": float(tr.rewards.mean()), **summary}
        first = first_event_diff(tr, records[name])
        rows[name] = {"us_per_slot": us, **got, "first_event_diff_slot": first,
                      "capacity_excess": capacity_excess(tr, spec, None), "launches": launched}
        emit({"phase": "lifecycle", "algorithm": name, **rows[name]})
        check(launched == expected_launches(name, cfg.T, N, L),
              f"lifecycle {name}: launches {launched}")
        check(rows[name]["capacity_excess"] <= 0.0, f"lifecycle {name}: over capacity")
        bars = DRIFT_BARS if first is not None else {"*": REWARD_RTOL}
        rows[name]["errors"] = hold_metrics(f"lifecycle {name}", got, LIFECYCLE_REFERENCE[name],
                                            bars)
    runs_s = time.perf_counter() - t_phase
    beside_s = 0.0
    if beside is not None:
        t0 = time.perf_counter()
        beside()
        beside_s = time.perf_counter() - t0
    # duration-1 reduction: every job's work 0 gives slot mode's rewards
    y0 = lifecycle.default_y0(spec)
    tr1 = lifecycle.run(spec, arr, torch.zeros_like(works), "ogasched", y0=y0)
    r_slot, _ = ogasched.run(spec, arr, eta0=25.0, decay=0.9999, y0=y0)
    scale = max(1.0, float(r_slot.abs().max()))
    d1_err = float((tr1.rewards - r_slot).abs().max())
    check(d1_err <= 1e-4 * scale, f"lifecycle duration-1 vs slot mode: {d1_err}")
    check(bool((tr1.jct[tr1.departed] == 1.0).all()) and int(tr1.dropped[-1]) == 0,
          "lifecycle duration-1: a job queued or stayed")
    # where an OGASCHED lifecycle slot's time goes: 100 profiled slots
    lifecycle.run(spec, arr[:100], works[:100], "ogasched", y0=y0)
    profile = device_profile(torch, lambda: lifecycle.run(spec, arr[:100], works[:100],
                                                          "ogasched", y0=y0))
    profile["us_per_slot"] = profile["wall_ms"] * 1e3 / 100
    profile["device_busy_us_per_slot"] = profile["device_busy_ms"] * 1e3 / 100
    line = {"phase": "lifecycle", "config": LIFECYCLE_CFG,
            "bars": {"no_drift": REWARD_RTOL, "drift": DRIFT_BARS},
            "duration1_max_abs": d1_err, "duration1_bar": 1e-4 * scale,
            "ogasched_slot_profile": profile, "runs_s": runs_s,
            "phase_s": time.perf_counter() - t_phase - beside_s,
            "runs_beside_faults_workers": beside is not None,
            "summary": {n: {k: r[k] for k in ("us_per_slot", "jct_mean", "goodput",
                                              "first_event_diff_slot")}
                        for n, r in rows.items()}}
    emit(line)
    return line


def faults_regime(torch, regime: str) -> dict:
    """One fault regime of benchmarks/bench_faults.py's quick configuration
    through lifecycle.run for every algorithm of FAULTS_ALGORITHMS, each
    held to the reference's readings: {"algorithm": row}."""
    from repro_torch.sched import lifecycle, trace

    with open(os.path.join(ROOT, LIFECYCLE_EVENTS)) as f:
        records = json.load(f)["faults"]["records"][regime]
    cfg = trace.TraceConfig(**FAULTS_CFG, faults=trace.FaultConfig(**FAULT_REGIMES[regime]))
    spec, arr, works = trace.make_lifecycle(cfg)
    faults = trace.build_faults(cfg) if cfg.faults.active else None
    f_np = (np.ones((cfg.T, cfg.K), np.float32) if faults is None
            else faults.cpu().numpy())
    N, L = cfg.R * cfg.K, cfg.L
    out = {}
    for name in FAULTS_ALGORITHMS:
        before = launch_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = lifecycle.run(spec, arr, works, name, faults=faults)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = launch_delta(before, launch_snapshot())
        s = lifecycle.summarize(tr, spec)
        got = {k: s[k] for k in ("goodput", "wasted_work", "evictions", "fault_drops",
                                 "completed")}
        got["recovery_time"] = lifecycle.recovery_time(tr.rewards.cpu().numpy(), f_np)
        first = first_event_diff(tr, records[name])
        row = {"us_per_slot": seconds * 1e6 / cfg.T, "seconds": seconds, **got,
               "first_event_diff_slot": first,
               "capacity_excess": capacity_excess(tr, spec, faults), "launches": launched}
        check(launched == expected_launches(name, cfg.T, N, L),
              f"faults {regime} {name}: launches {launched}")
        check(row["capacity_excess"] <= 0.0, f"faults {regime} {name}: over capacity")
        row["errors"] = hold_metrics(f"faults {regime} {name}", got,
                                     FAULTS_REFERENCE[regime][name],
                                     DRIFT_BARS if first is not None else {"*": REWARD_RTOL})
        out[name] = row
    return out


def faults_worker(regime: str, out_path: str) -> int:
    """The faults phase's subprocess (this script with --faults-worker): one
    regime's runs with every check, written to ``out_path`` with the
    kernels' launches (as ``smoke``'s ``launches()`` counts them, and by
    shape) and the nvcc runs of this process."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import compat
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import oga_step, proj_bisect, sortscan

    # the parent's numerics settings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    rows = faults_regime(torch, regime)
    counts = [oga_step.oga_step_fused.launches, sortscan.proj_sortscan.launches,
              proj_bisect.proj_bisect.launches, fa.flash_attention.kernel_launches["bf16"],
              fa.flash_attention.kernel_launches["float32"],
              fa.flash_attention_bwd.kernel_launches["bf16"],
              fa.flash_attention_bwd.kernel_launches["float32"]]
    by_shape = {name: {f"{N}x{L}": n for (N, L), n in w.launches_by_shape.items()}
                for name, w in (("oga_step_fused", oga_step.oga_step_fused),
                                ("proj_sortscan", sortscan.proj_sortscan))}
    with open(out_path, "w") as f:
        json.dump({"rows": rows, "launches": counts, "launches_by_shape": by_shape,
                   "compiles": compat.backend_compile_count(),
                   "worker_s": time.perf_counter() - t0, "end": time.time()}, f)
    return 0


def start_faults_workers() -> dict:
    """The faults phase's worker processes, one a regime of FAULT_REGIMES
    (this script with --faults-worker), all started at once."""
    import subprocess

    tmp = tempfile.mkdtemp(prefix="repro-torch-faults-")
    procs = {}
    for regime in FAULT_REGIMES:
        log = open(os.path.join(tmp, f"{regime}.log"), "w")
        procs[regime] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--faults-worker", regime,
             os.path.join(tmp, f"{regime}.json")],
            stdout=log, stderr=subprocess.STDOUT), log)
    return {"tmp": tmp, "procs": procs, "start": time.time()}


def stop_workers(workers: dict) -> None:
    """Kill whichever of ``start_faults_workers``'s processes still runs,
    close their logs and remove their directory."""
    for proc, log in workers["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    shutil.rmtree(workers["tmp"], ignore_errors=True)


def faults_phase(workers: dict) -> dict:
    """benchmarks/bench_faults.py's quick configuration under its four
    regimes, held to the reference's readings: one worker process of this
    script a regime, the four at once (``start_faults_workers``; the runs
    are host-bound, so their slot times are taken beside the other
    workers' and the lifecycle phase's runs). Waits for the workers and
    emits their rows. Returns the phase's line with the workers' launches
    ("launches", "launches_by_shape"), which the lifecycle path adds to its
    own; "phase_s" is the workers' wall, from their start to the last one's
    end."""
    tmp = workers["tmp"]
    try:
        results, failed = {}, []
        for regime, (proc, log) in workers["procs"].items():
            rc = proc.wait(timeout=FAULTS_WORKER_TIMEOUT_S)
            if rc != 0:
                with open(os.path.join(tmp, f"{regime}.log")) as f:
                    failed.append(f"{regime} (exit {rc}): {f.read()[-3000:]}")
                continue
            with open(os.path.join(tmp, f"{regime}.json")) as f:
                results[regime] = json.load(f)
    finally:
        stop_workers(workers)
    check(not failed, "faults workers failed: " + "\n".join(failed))
    out = {}
    for regime, res in results.items():
        for name, row in res["rows"].items():
            emit({"phase": "faults", "regime": regime, "algorithm": name, **row})
            out[f"{regime}/{name}"] = row
    compiles = {r: res["compiles"] for r, res in results.items()}
    check(not any(compiles.values()), f"a faults worker compiled kernels: {compiles}")
    launches = [sum(res["launches"][i] for res in results.values()) for i in range(7)]
    by_shape = {}
    for res in results.values():
        for name, shapes in res["launches_by_shape"].items():
            for shape, n in shapes.items():
                by_shape.setdefault(name, {})[shape] = by_shape.get(name, {}).get(shape, 0) + n
    phase_s = max(res["end"] for res in results.values()) - workers["start"]
    runs_s = sum(r["seconds"] for r in out.values())
    line = {"phase": "faults", "config": FAULTS_CFG, "regimes": FAULT_REGIMES,
            "bars": {"no_drift": REWARD_RTOL, "drift": DRIFT_BARS},
            "workers": len(results), "phase_s": phase_s, "runs_s": runs_s,
            "phase_over_runs": phase_s / runs_s,
            "worker_s": {r: res["worker_s"] for r, res in results.items()},
            "goodput": {k: r["goodput"] for k, r in out.items()},
            "first_event_diff_slot": {k: r["first_event_diff_slot"] for k, r in out.items()},
            "worst_error": max(max(r["errors"].values()) for r in out.values()),
            "launches": launches, "launches_by_shape": by_shape}
    emit({k: v for k, v in line.items() if k not in ("launches", "launches_by_shape")})
    return line


def grid_lifecycle_phase(torch, dev) -> dict:
    """sweep.run_grid(mode="lifecycle") over 8 Fig. 2 configs, faults off
    and on, each row against simulator.run_all(mode="lifecycle")."""
    from repro_torch.sched import simulator, sweep, trace

    t_phase = time.perf_counter()
    out = {}
    for label, fkw in (("clean", {}), ("failures", FAULT_REGIMES["failures"])):
        base = trace.TraceConfig(T=GRID_LIFECYCLE_T, L=10, R=128, K=6, contention=10.0,
                                 faults=trace.FaultConfig(**fkw))
        points = sweep.make_grid(base, seeds=range(GRID_LIFECYCLE_CONFIGS))
        batch = sweep.build_batch(points, mode="lifecycle")
        before = launch_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traces = sweep.run_grid(batch, GRID_LIFECYCLE_ALGORITHMS, mode="lifecycle")
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6 / GRID_LIFECYCLE_T
        launched = launch_delta(before, launch_snapshot())
        N = GRID_LIFECYCLE_CONFIGS * 128 * 6
        want = {k: {} for k in launched}
        for name in GRID_LIFECYCLE_ALGORITHMS:
            for k, v in expected_launches(name, GRID_LIFECYCLE_T, N, 10).items():
                for shape, n in v.items():
                    want[k][shape] = want[k].get(shape, 0) + n
        check(launched == want, f"grid_lifecycle {label}: launches {launched}")
        summary = sweep.summarize_lifecycle(traces, batch)
        worst = 0.0
        for g, p in enumerate(points):
            single = simulator.run_all(p.cfg, algorithms=GRID_LIFECYCLE_ALGORITHMS,
                                       mode="lifecycle")
            for name in GRID_LIFECYCLE_ALGORITHMS:
                r = traces[name].rewards[g].cpu().numpy()
                err = float(np.abs(r - single[name].rewards).max()
                            / max(1.0, float(np.abs(single[name].rewards).max())))
                check(err <= GRID_LIFECYCLE_RTOL, f"grid_lifecycle {label} row {g} {name}: {err}")
                # wasted work sums size - remaining at evictions: its rounding
                # scales with the job sizes, not with the (small) sum
                errs = hold_metrics(f"grid_lifecycle {label} row {g} {name}",
                                    {k: float(summary[f"{k}/{name}"][g])
                                     for k in single[name].lifecycle},
                                    single[name].lifecycle, {"*": GRID_LIFECYCLE_RTOL},
                                    {"wasted_work": base.work_mean})
                worst = max(worst, err, *errs.values())
        out[label] = {"per_step_us": us, "launches": launched, "row_vs_run_all_worst": worst,
                      "goodput_mean": {n: float(summary[f"goodput/{n}"].mean())
                                       for n in GRID_LIFECYCLE_ALGORITHMS}}
    line = {"phase": "grid_lifecycle", "configs": GRID_LIFECYCLE_CONFIGS, "T": GRID_LIFECYCLE_T,
            "algorithms": list(GRID_LIFECYCLE_ALGORITHMS), "rtol": GRID_LIFECYCLE_RTOL,
            **out, "phase_s": time.perf_counter() - t_phase}
    emit(line)
    return line


def timed_stream(sweep, points, mode: str, chunk: int, trace_backend: str, rows: bool = False):
    """``sweep.run_grid_stream`` driven as ``sweep_stream`` drives it (the
    chunk's inputs dropped, each chunk reduced as it finishes), with its
    ``stats``. Returns (wall_s, summary, overlap_ratio, rows): overlap_ratio
    = 1 - chunk_wait_s / wall, rows the per-config rewards (slot mode) when
    ``rows``."""
    import torch

    stats, parts, kept = {}, {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, batch, out in sweep.run_grid_stream(points, STREAM_ALGORITHMS, chunk_size=chunk,
                                               mode=mode, trace_backend=trace_backend,
                                               donate=True, stats=stats):
        summ = sweep.summarize_lifecycle(out, batch) if mode == "lifecycle" \
            else sweep.summarize(out)
        for k, v in summ.items():
            parts.setdefault(k, []).append(v)
        if rows:
            for n, r in out.items():
                kept.setdefault(n, []).append(r.cpu().numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = {k: np.concatenate(v) for k, v in parts.items()}
    overlap = 1.0 - stats.get("chunk_wait_s", 0.0) / wall
    return wall, summary, overlap, {n: np.concatenate(v) for n, v in kept.items()}


def summary_ok(summary: dict, n: int) -> bool:
    return all(v.shape == (n,) and np.isfinite(v).all() for v in summary.values())


def stream_phase(torch, dev, grid_points, grid_rows) -> dict:
    """benchmarks/bench_sweep.py's streamed grids on the card: (a) 10000
    slot-mode configs with device traces, (b) the lifecycle grid, (c) host
    traces against the grid phase's resident rows, (d) device traces on the
    card against the CPU."""
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.sched import sweep, trace, trace_device

    t_phase = time.perf_counter()
    cfg = trace.TraceConfig(**STREAM_CFG)
    line = {"phase": "stream", "config": STREAM_CFG, "algorithms": list(STREAM_ALGORITHMS),
            "card": gpu_name_and_power_limit()}
    # (a) 10000 slot-mode configs, "auto" -> device traces
    points = sweep.make_grid(cfg, seeds=range(STREAM_POINTS))
    check(sweep.resolve_trace_backend("auto", len(points)) == "device",
          "stream: 'auto' did not resolve to device traces at 10000 points")
    n0 = launch_snapshot()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall, summ, overlap, _ = timed_stream(sweep, points, "slot", STREAM_CHUNK, "auto")
    peak = torch.cuda.max_memory_allocated() - base_mem
    launches = launch_delta(n0, launch_snapshot())
    chunks = -(-STREAM_POINTS // STREAM_CHUNK)
    n_rows = STREAM_CHUNK * cfg.R * cfg.K
    check(launches["oga_step_fused"] == {f"{n_rows}x{cfg.L}": chunks * cfg.T},
          f"stream slot: fused launches {launches['oga_step_fused']}")
    check(summary_ok(summ, STREAM_POINTS), "stream slot: summaries not finite or misshapen")
    # the padded last chunk's 16 configs, resident, against their streamed rows
    tail = points[(chunks - 1) * STREAM_CHUNK:]
    resident = sweep.summarize(sweep.run_grid(
        sweep.build_batch(tail, trace_backend="device"), STREAM_ALGORITHMS))
    tail_err = max(float(np.abs(resident[k] - v[-len(tail):]).max()
                         / max(float(np.abs(resident[k]).max()), 1.0))
                   for k, v in summ.items())
    check(tail_err <= 1e-6, f"stream slot: the last chunk's rows vs resident {tail_err}")
    # where one chunk's time goes: its trace synthesis and each algorithm
    held = {}
    chunk_profile = {"trace_device": device_profile(torch, lambda: held.setdefault(
        "batch", sweep.build_batch(points[:STREAM_CHUNK], trace_backend="device")))}
    for name in STREAM_ALGORITHMS:
        chunk_profile[name] = device_profile(
            torch, lambda: sweep.run_grid(held["batch"], (name,)), n_top=3)
    del held
    model = sweep.grid_memory_bytes(cfg, STREAM_CHUNK, algorithms=STREAM_ALGORITHMS, prefetch=2)
    check(peak <= STREAM_PEAK_RATIO * model["total"],
          f"stream slot: peak {peak} B above {STREAM_PEAK_RATIO} x the model's {model['total']}")
    line["slot"] = {
        "configs": STREAM_POINTS, "chunk": STREAM_CHUNK, "trace_backend": "device",
        "wall_s": wall, "configs_per_s": STREAM_POINTS / wall, "overlap_ratio": overlap,
        "peak_bytes": peak, "model_bytes": model,
        "peak_over_model": peak / model["total"], "launches": launches,
        "last_chunk_vs_resident": tail_err, "chunk_profile": chunk_profile,
        "summary_mean": {k: float(v.mean()) for k, v in summ.items()}}
    emit({"phase": "stream", "part": "slot", **line["slot"]})
    # (b) the lifecycle grid, device traces
    life = points[:STREAM_LIFECYCLE_POINTS]
    n0 = launch_snapshot()
    wall, summ, overlap, _ = timed_stream(sweep, life, "lifecycle", STREAM_LIFECYCLE_CHUNK,
                                          "device")
    launches = launch_delta(n0, launch_snapshot())
    chunks = -(-len(life) // STREAM_LIFECYCLE_CHUNK)
    shape = f"{STREAM_LIFECYCLE_CHUNK * cfg.R * cfg.K}x{cfg.L}"
    check(launches == {"oga_step_fused": {shape: chunks * cfg.T},
                       "proj_sortscan": {shape: 2 * chunks * cfg.T}},
          f"stream lifecycle: launches {launches}")
    check(summary_ok(summ, len(life)), "stream lifecycle: summaries not finite or misshapen")
    check(bool((summ["completed/ogasched"] > 0).any()), "stream lifecycle: no job completed")
    first = life[:STREAM_LIFECYCLE_CHUNK]
    fb = sweep.build_batch(first, mode="lifecycle", trace_backend="device")
    resident = sweep.summarize_lifecycle(
        sweep.run_grid(fb, STREAM_ALGORITHMS, mode="lifecycle"), fb)
    same = all(np.array_equal(v, summ[k][:len(first)], equal_nan=True)
               for k, v in resident.items())
    # where a chunk's time goes: its first STREAM_PROFILE_SLOTS slots
    head = dataclasses.replace(fb, arrivals=fb.arrivals[:, :STREAM_PROFILE_SLOTS],
                               works=fb.works[:, :STREAM_PROFILE_SLOTS])
    chunk_profile = {name: device_profile(torch, lambda: sweep.run_grid(
        head, (name,), mode="lifecycle"), n_top=3) for name in STREAM_ALGORITHMS}
    del head
    check(same, "stream lifecycle: the first chunk's summaries differ from a resident run")
    line["lifecycle"] = {
        "configs": len(life), "of": 2000, "chunk": STREAM_LIFECYCLE_CHUNK,
        "trace_backend": "device", "wall_s": wall, "configs_per_s": len(life) / wall,
        "overlap_ratio": overlap, "launches": launches, "first_chunk_bitwise_resident": same,
        "chunk_profile": chunk_profile,
        "summary_mean": {k: float(np.nanmean(v)) for k, v in summ.items()}}
    emit({"phase": "stream", "part": "lifecycle", **line["lifecycle"]})
    # (c) host traces: the grid phase's 64 configs against its resident rows
    n0 = launch_snapshot()
    wall, summ, overlap, rows = timed_stream(sweep, grid_points, "slot", STREAM_HOST_CHUNK,
                                             "host", rows=True)
    launches = launch_delta(n0, launch_snapshot())
    g_cfg = grid_points[0].cfg
    chunks = -(-len(grid_points) // STREAM_HOST_CHUNK)
    check(launches["oga_step_fused"] == {
        f"{STREAM_HOST_CHUNK * g_cfg.R * g_cfg.K}x{g_cfg.L}": chunks * g_cfg.T},
        f"stream host: fused launches {launches['oga_step_fused']}")
    check(np.array_equal(rows["ogasched"], grid_rows["ogasched"]),
          "stream host: OGASCHED's streamed rows are not the grid phase's resident rows, "
          f"max {float(np.abs(rows['ogasched'] - grid_rows['ogasched']).max())}")
    fair_diff = float(np.abs(rows["fairness"] - grid_rows["fairness"]).max())
    check(fair_diff <= TRAJ_TOL * float(np.abs(grid_rows["fairness"]).max()),
          f"stream host: FAIRNESS rows vs resident {fair_diff}")
    line["host"] = {"configs": len(grid_points), "chunk": STREAM_HOST_CHUNK,
                    "trace_backend": "host", "wall_s": wall, "overlap_ratio": overlap,
                    "launches": launches, "ogasched_bitwise_resident": True,
                    "fairness_max_abs_diff": fair_diff}
    emit({"phase": "stream", "part": "host", **line["host"]})
    # (d) device traces on the card against the CPU
    fc = trace.FaultConfig(fail_rate=0.02, drain_period=50, shock_rate=0.01)
    cfgs = [dataclasses.replace(p.cfg, faults=fc) for p in points[:STREAM_DEVICE_CONFIGS]]
    seeds = [c.seed for c in cfgs]
    sizes = {"spec": (7, cfg.R * cfg.K), "arrivals": (3, cfg.T * cfg.L),
             "works": (1, cfg.T * cfg.L), "faults": (4, cfg.T * cfg.K)}
    bits_equal = {}
    for stream, (n, size) in sizes.items():
        on = [trace_device.stream_bits(torch.tensor(seeds, device=d), stream, (size,) * n)
              for d in (dev, "cpu")]
        bits_equal[stream] = all(torch.equal(a.cpu(), b) for a, b in zip(*on))
    check(all(bits_equal.values()), f"stream devices: hash words differ {bits_equal}")
    card = trace_device.make_batch(cfgs, with_works=True, with_faults=True, device=dev)
    host = trace_device.make_batch(cfgs, with_works=True, with_faults=True, device="cpu")
    spec_equal = all(torch.equal(getattr(card[0], f).cpu(), getattr(host[0], f))
                     for f in card[0].FIELDS)
    arrival_flips = float((card[1].cpu() != host[1]).float().mean())
    works_rel = float(((card[2].cpu() - host[2]).abs() / host[2].abs()).max())
    fault_flips = float(((card[3].cpu() - host[3]).abs() > 1e-6).float().mean())
    faults_max_abs = float((card[3].cpu() - host[3]).abs().max())
    check(spec_equal, "stream devices: the spec differs between the card and the CPU")
    check(arrival_flips <= STREAM_ARRIVAL_FLIPS, f"stream devices: arrivals {arrival_flips}")
    check(works_rel <= STREAM_WORKS_RTOL, f"stream devices: job sizes {works_rel}")
    check(fault_flips <= STREAM_FAULT_FLIPS, f"stream devices: faults {fault_flips}")
    line["devices"] = {"configs": len(cfgs), "bits_equal": bits_equal, "spec_equal": spec_equal,
                       "arrival_flips": arrival_flips, "works_max_rel": works_rel,
                       "fault_flips": fault_flips, "faults_max_abs": faults_max_abs}
    emit({"phase": "stream", "part": "devices", **line["devices"]})
    line["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "stream", "phase_s": line["phase_s"], "card": line["card"]})
    return line


def resume_worker(ckpt_dir: str, out_path: str, slow: bool) -> int:
    """The resume phase's subprocess: the checkpointed stream over the
    first RESUME_POINTS configs, its summaries saved to ``out_path``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.sched import sweep, trace

    points = sweep.make_grid(trace.TraceConfig(**STREAM_CFG), seeds=range(RESUME_POINTS))
    if slow:
        real = sweep.summarize

        def slow_summarize(out):
            time.sleep(RESUME_SLOW_S)
            return real(out)

        sweep.summarize = slow_summarize
    summary = sweep.sweep_stream(points, STREAM_ALGORITHMS, chunk_size=RESUME_CHUNK,
                                 checkpoint_dir=ckpt_dir)
    np.savez(out_path, **{k.replace("/", "|"): v for k, v in summary.items()})
    print("RESUME-SWEEP-DONE", flush=True)
    return 0


def resume_phase(torch, dev) -> dict:
    """Kill a checkpointed stream with SIGKILL, resume it in a fresh
    process, and hold the result to an uninterrupted run, bit for bit."""
    import hashlib
    import signal
    import subprocess

    from repro_torch.ckpt import checkpoint as ckpt_io
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.sched import sweep, trace

    t_phase = time.perf_counter()
    points = sweep.make_grid(trace.TraceConfig(**STREAM_CFG), seeds=range(RESUME_POINTS))
    n_chunks = RESUME_POINTS // RESUME_CHUNK

    def spawn(d, out, slow):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--resume-worker", d, out,
             "slow" if slow else "fast"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def shas(d):
        out = {}
        for s in ckpt_io.available_steps(d):
            if ckpt_io.verify_checkpoint(d, s):
                with open(os.path.join(d, f"step_{s:08d}.npz"), "rb") as f:
                    out[s] = hashlib.sha256(f.read()).hexdigest()
        return out

    with tempfile.TemporaryDirectory(prefix="repro-torch-resume-") as tmp:
        d = os.path.join(tmp, "ckpt")
        out = os.path.join(tmp, "resumed.npz")
        p = spawn(d, os.path.join(tmp, "unused.npz"), slow=True)
        try:
            deadline = time.time() + RESUME_WAIT_S
            while time.time() < deadline and p.poll() is None:
                if len(shas(d)) >= RESUME_KILL_AFTER:
                    break
                time.sleep(0.02)
            if p.poll() is not None:
                stdout, stderr = p.communicate(timeout=60)
                check(False, f"resume: the sweep exited before the kill:\n{stdout}{stderr[-4000:]}")
            os.kill(p.pid, signal.SIGKILL)
        finally:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        check(p.returncode == -signal.SIGKILL, f"resume: the worker exited {p.returncode}")
        ck = sweep.SweepCheckpoint(d, points, STREAM_ALGORITHMS, chunk_size=RESUME_CHUNK)
        survived = ck.completed_chunks()
        check(RESUME_KILL_AFTER <= survived < n_chunks,
              f"resume: {survived} of {n_chunks} chunks survived the kill")
        before = shas(d)
        t0 = time.perf_counter()
        p2 = spawn(d, out, slow=False)
        try:
            stdout, stderr = p2.communicate(timeout=RESUME_WAIT_S)
        finally:
            if p2.poll() is None:
                p2.kill()
                p2.wait(timeout=60)
        resume_s = time.perf_counter() - t0
        check("RESUME-SWEEP-DONE" in stdout, f"resume: the resumed sweep failed:\n{stderr[-4000:]}")
        check(ck.completed_chunks() == n_chunks, "resume: the store is not complete")
        after = shas(d)
        rewritten = [s for s in range(survived) if after[s] != before[s]]
        check(not rewritten, f"resume: surviving chunks {rewritten} were rewritten")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = sweep.sweep_stream(points, STREAM_ALGORITHMS, chunk_size=RESUME_CHUNK)
        torch.cuda.synchronize()
        straight_s = time.perf_counter() - t0
        with np.load(out) as got:
            check(set(got.files) == {k.replace("/", "|") for k in ref},
                  "resume: the resumed summaries have other metrics")
            differ = [k for k in ref if not np.array_equal(got[k.replace("/", "|")], ref[k])]
        check(not differ, f"resume: resumed summaries differ from the uninterrupted run: {differ}")
        try:
            sweep.SweepCheckpoint(d, points[:-1], STREAM_ALGORITHMS, chunk_size=RESUME_CHUNK)
            mismatch = False
        except sweep.SweepResumeMismatch:
            mismatch = True
        check(mismatch, "resume: a store of another grid was accepted")
    line = {"phase": "resume", "configs": RESUME_POINTS, "chunk": RESUME_CHUNK,
            "chunks": n_chunks, "survived_kill": survived, "surviving_chunks_untouched": True,
            "bitwise_equal_uninterrupted": True, "other_grid_refused": True,
            "resume_process_s": resume_s, "uninterrupted_s": straight_s,
            "card": gpu_name_and_power_limit(), "phase_s": time.perf_counter() - t_phase}
    emit(line)
    return line


def regret_validation_phase(torch, dev) -> dict:
    """benchmarks/bench_regret.py's quick Theorem-1 grid through
    core.regret.regret_validation on the card, every cell against the
    reference's pinned readings."""
    import warnings

    from repro_torch.core import regret
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.sched import trace

    t_phase = time.perf_counter()
    cfg = trace.TraceConfig(**REGRET_CFG)
    points, labels = regret.make_regret_grid(cfg, utilities=REGRET_UTILITIES,
                                             regimes=REGRET_REGIMES, seeds=REGRET_SEEDS)
    n0 = launch_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        records = regret.regret_validation(points, labels, chunk_size=REGRET_CHUNK,
                                           oracle_iters=REGRET_ORACLE_ITERS,
                                           n_boot=REGRET_N_BOOT)
    wall = time.perf_counter() - t0
    launches = launch_delta(n0, launch_snapshot())
    chunks = -(-len(points) // REGRET_CHUNK)
    shape = f"{REGRET_CHUNK * cfg.R * cfg.K}x{cfg.L}"
    check(launches == {"oga_step_fused": {shape: chunks * cfg.T},
                       "proj_sortscan": {shape: chunks * REGRET_ORACLE_ITERS}},
          f"regret_validation: launches {launches}")
    # where a chunk's time goes: a REGRET_PROFILE_SHARE of its work (as
    # many slots and oracle steps), the same mix of steps; the profiler's
    # own accounting of a whole chunk's ~580k host ops takes ~2 minutes
    from repro_torch.sched import sweep

    batch = sweep.build_batch(points[:REGRET_CHUNK])
    chunk_profile = device_profile(torch, lambda: regret.regret_curves_batch(
        batch.spec, batch.arrivals[:, : cfg.T // REGRET_PROFILE_SHARE], batch.eta0,
        batch.decay, oracle_iters=REGRET_ORACLE_ITERS // REGRET_PROFILE_SHARE), n_top=4)
    chunk_profile["share_of_chunk"] = 1.0 / REGRET_PROFILE_SHARE
    del batch
    cells, worst = {}, {"r_T_mean": 0.0, "exponent": 0.0, "bound": 0.0}
    for r in records:
        key = f"{r['utility']}/{r['regime']}"
        errs = regret_errors(r, REGRET_REFERENCE[key])
        check(errs["flags_equal"], f"regret_validation {key}: flags {r} vs {REGRET_REFERENCE[key]}")
        check(errs["r_T_mean"] <= REGRET_R_T_BAR, f"regret_validation {key}: r_T_mean {errs}")
        check(errs["exponent"] <= REGRET_EXPONENT_ATOL, f"regret_validation {key}: exponent {errs}")
        check(errs["bound"] <= REGRET_BOUND_RTOL, f"regret_validation {key}: bound {errs}")
        check(r["bound_ok"], f"regret_validation {key}: mean R_T above H_G sqrt(T) (Thm. 1)")
        cells[key] = {k: r[k] for k in ("r_T_mean", "bound", "exponent", "ci_lo", "ci_hi",
                                        "bound_ok", "sublinear")}
        worst = {k: max(worst[k], errs[k]) for k in worst}
    check(len(cells) == len(REGRET_REFERENCE), f"regret_validation: {len(cells)} cells")
    line = {"phase": "regret_validation", "config": REGRET_CFG, "points": len(points),
            "chunk": REGRET_CHUNK, "oracle_iters": REGRET_ORACLE_ITERS, "n_boot": REGRET_N_BOOT,
            "wall_s": wall, "configs_per_s": len(points) / wall, "launches": launches,
            "chunk_profile": chunk_profile, "cells": cells, "worst_error": worst,
            "bars": {"r_T_mean": REGRET_R_T_BAR, "exponent": REGRET_EXPONENT_ATOL,
                     "bound": REGRET_BOUND_RTOL},
            "card": gpu_name_and_power_limit(), "phase_s": time.perf_counter() - t_phase}
    emit(line)
    return line


def extensions_phase(torch, dev, fig2_rewards: np.ndarray) -> dict:
    """The extensions path: §3.4 at Fig. 2 (and its J = 1 expansion bit for
    bit the fig2 phase's OGASCHED rewards), §3.5 at Fig. 2's scale, §3.2 at
    the dry-run's scheduler cell on 1 and 4 shards, and the job manager,
    each against the reference's pins or the unsharded step; the fused
    kernel's launches by packed shape."""
    from repro_torch.core import extensions, ogasched
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.sched import trace

    t_phase = time.perf_counter()
    n0 = launch_snapshot()
    multi = multi_arrival_run(torch, dev)
    spec2, arr2 = trace.make(trace.TraceConfig(**EXT_MULTI_CFG), device=dev)
    espec1, x1 = extensions.expand_multi_arrival(spec2, arr2.to(torch.int32), 1)
    r1, _ = ogasched.run(espec1, x1, eta0=EXT_ETA0, decay=EXT_DECAY, device=dev)
    j1_bitwise = bool(np.array_equal(r1.cpu().numpy(), fig2_rewards))
    del spec2, arr2, espec1, x1, r1
    gang = gang_run(torch, dev)
    jobs = job_manager_run(torch, dev)
    errs = extension_errors(multi, gang, jobs, EXTENSIONS_REFERENCE)
    dist = distributed_run(torch, dev)
    launches = launch_delta(n0, launch_snapshot())
    T2, steps = EXT_MULTI_CFG["T"], EXT_DIST_CFG["T"]
    rows = EXT_DIST_CFG["R"] * EXT_DIST_CFG["K"]
    expected = {"oga_step_fused": {
        "x".join(map(str, multi["shape"])): T2, f"{multi['shape'][0]}x{EXT_MULTI_CFG['L']}": T2,
        "x".join(map(str, gang["shape"])): EXT_GANG_T, "x".join(map(str, jobs["shape"])):
        EXT_JOB_SLOTS, f"{rows}x{EXT_DIST_CFG['L']}": steps * (1 + EXT_DIST_SHARDS.count(1)),
        **{f"{rows // n}x{EXT_DIST_CFG['L']}": steps * n for n in EXT_DIST_SHARDS if n > 1}},
        "proj_sortscan": {}}
    line = {"phase": "extensions", "phase_s": time.perf_counter() - t_phase,
            "multi_arrival": {k: v for k, v in multi.items() if k != "rewards"},
            "multi_arrival_j1_bitwise_fig2": j1_bitwise,
            "gang": {k: v for k, v in gang.items() if k not in ("q", "kept")},
            "job_manager": {"shape": jobs["shape"], "us_per_slot": jobs["us_per_slot"],
                            "grants_first_slots": jobs["grants"][:4], "meshes": jobs["meshes"]},
            "distributed": dist, "vs_reference": errs, "launches": launches,
            "bars": {"multi_prefix_avg_reward": REWARD_RTOL, "multi_per_slot": TRAJ_TOL,
                     "multi_avg_reward": REWARD_RTOL, "gang_sum_q": REWARD_RTOL,
                     "dist_y_atol": EXT_DIST_Y_ATOL, "dist_q_rtol": EXT_DIST_Q_RTOL},
            "card": gpu_name_and_power_limit()}
    emit(line)
    check(errs["multi_J_equal"] and multi["feasible"],
          f"extensions §3.4: J {multi['J']}, feasible {multi['feasible']}")
    check(j1_bitwise, "extensions §3.4: the J = 1 expansion moved the fig2 OGASCHED rewards")
    check(errs["multi_prefix_avg_reward"] <= REWARD_RTOL,
          f"extensions §3.4: the first slots' average is off the reference's: {errs}")
    check(errs["multi_avg_reward"] <= REWARD_RTOL,
          f"extensions §3.4: average reward {multi['avg_reward']} vs reference: {errs}")
    check(gang["feasible_slots"] == gang["all_or_nothing_slots"] == EXT_GANG_T,
          f"extensions §3.5: infeasible or not All-or-Nothing slots: {line['gang']}")
    check(errs["gang_sum_q"] <= REWARD_RTOL and errs["gang_first_kept_diff"] is None,
          f"extensions §3.5: sum q or kept masks vs the reference: {errs}")
    check(errs["jobs_grants_equal"] and errs["jobs_meshes_equal"],
          f"extensions job manager: grants {jobs['grants']} meshes {jobs['meshes']}")
    check(dist["one_shard_y_bitwise"] and dist["feasible"],
          f"extensions §3.2: one shard not bit for bit, or infeasible: {dist}")
    check(dist["dryrun"]["equal"],
          f"extensions §3.2: the dry run's per-position bytes are not the shard's: "
          f"{dist['dryrun']}")
    for n, e in dist["vs_unsharded"].items():
        check(e["y_max_abs"] <= EXT_DIST_Y_ATOL and e["q_rel"] <= EXT_DIST_Q_RTOL,
              f"extensions §3.2 {n} shards vs unsharded: {e}")
    check(launches == expected, f"extensions: launches {launches}, expected {expected}")
    return line


def multi_arrival_run(torch, dev, slots=None) -> dict:
    """§3.4 at Fig. 2's config: Poisson counts expanded to L*J virtual
    ports, OGASCHED over them (one fused launch a slot at (R*K, L*J)); over
    the first ``slots`` slots only when given (J is the whole trace's)."""
    from repro_torch.core import extensions, graph, ogasched
    from repro_torch.sched import trace

    cfg = trace.TraceConfig(**EXT_MULTI_CFG)
    spec = trace.build_spec(cfg, dev)
    arr = trace.build_arrivals(cfg, multi=True, device=dev)
    J = int(arr.max())
    espec, x_exp = extensions.expand_multi_arrival(spec, arr[:slots], J)
    t0 = time.perf_counter()
    rewards, y = ogasched.run(espec, x_exp, eta0=EXT_ETA0, decay=EXT_DECAY, device=dev)
    rewards = rewards.cpu().numpy()
    wall = time.perf_counter() - t0
    return {"J": J, "ports": espec.L, "shape": [cfg.R * cfg.K, espec.L],
            "avg_reward": float(rewards.mean()), "rewards": rewards,
            "feasible": bool(graph.feasible(espec, y)), "us_per_slot": wall * 1e6 / len(rewards)}


def gang_run(torch, dev) -> dict:
    """§3.5 on Fig. 2's spec: EXT_GANG_T gang steps from y = 0, each slot's
    reward, kept-port mask, feasibility and All-or-Nothing flag (every
    job type has 0 or at least m_l scheduled tasks)."""
    from repro_torch.core import extensions, graph
    from repro_torch.kernels import ops
    from repro_torch.sched import trace

    cfg = trace.TraceConfig(**EXT_MULTI_CFG)
    spec, arr = trace.make(cfg, device=dev)
    req = gang_task_requests(spec.L, spec.K)
    espec, pot, _ = extensions.expand_gang(spec, req)
    m_min = torch.from_numpy(gang_m_min(req)).to(dev)
    L, T = spec.L, EXT_GANG_T
    operands = ops.pack_spec_operands(espec)
    eta = torch.tensor(EXT_GANG_ETA, device=dev)
    y = torch.zeros((espec.L, espec.R, espec.K), device=dev)
    qs = torch.empty(T, device=dev)
    kept = torch.empty((T, L), device=dev)
    ok = torch.empty((T, 2), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for t in range(T):
        y, qs[t] = extensions.gang_oga_step(espec, arr[t], y, eta, pot, m_min, L,
                                            operands=operands)
        kept[t] = extensions.kept_ports(y, pot, m_min, L)
        n_sched = ((y.sum((1, 2)) > 1e-6).to(y.dtype).reshape(L, EXT_GANG_Q)).sum(1)
        ok[t, 0] = graph.feasible(espec, y)
        ok[t, 1] = ((n_sched == 0) | (n_sched >= m_min)).all()
    qs, kept, ok = qs.cpu().numpy(), kept.cpu().numpy() > 0, ok.cpu().numpy()
    wall = time.perf_counter() - t0
    return {"T": T, "shape": [spec.R * spec.K, espec.L], "m_min": gang_m_min(req).tolist(),
            "sum_q": float(qs.sum(dtype=np.float64)), "q": qs, "kept": kept,
            "feasible_slots": int(ok[:, 0].sum()), "all_or_nothing_slots": int(ok[:, 1].sum()),
            "kept_ports_mean": float(kept.mean()), "us_per_slot": wall * 1e6 / T}


def job_manager_run(torch, dev) -> dict:
    """examples/elastic_cluster.py's scenario on the port: each slot's
    grants (template order, -1 where the job did not arrive) and the mesh
    plan_mesh gives each grant."""
    from repro_torch.launch.elastic import plan_mesh
    from repro_torch.sched import job_manager

    jobs = [job_manager.JobTemplate(arch=a, chips=c, hbm_gb=h) for a, c, h in EXT_JOBS]
    spec = job_manager.build_cluster(jobs, n_hosts=EXT_HOSTS, seed=0, device=dev)
    mgr = job_manager.JobManager(spec, jobs, device=dev)
    grants = []
    t0 = time.perf_counter()
    for x in job_arrivals():
        g = mgr.step(x)
        grants.append([g.get(j.arch, -1) for j in jobs])
    wall = time.perf_counter() - t0
    meshes = {str(g): list(plan_mesh(g)) for g in sorted({g for row in grants for g in row})
              if g > 0}
    return {"shape": [spec.R * spec.K, spec.L], "grants": grants, "meshes": meshes,
            "us_per_slot": wall * 1e6 / EXT_JOB_SLOTS}


def distributed_run(torch, dev) -> dict:
    """§3.2 at the dry-run's scheduler cell: EXT_DIST_STEPS steps of the
    unsharded fused oga_step, and from each step's y the sharded step on
    every shard count of EXT_DIST_SHARDS (all shards on ``dev``), held to
    it; host ms a step (synchronised) and peak device memory."""
    from repro_torch.core import distributed, graph, ogasched
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.sched import trace
    from repro_torch.train.meshctx import make_mesh

    cfg = trace.TraceConfig(**EXT_DIST_CFG)
    t0 = time.perf_counter()
    spec = trace.build_spec(cfg, dev)
    arr = trace.build_arrivals(cfg, device=dev)
    y = graph.random_feasible_decision(spec, np.random.default_rng(EXT_DIST_Y0_SEED))
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    eta = torch.tensor(EXT_DIST_ETA, device=dev)
    operands = ops.pack_spec_operands(spec)
    meshes = {n: [dev] * n for n in EXT_DIST_SHARDS}
    steps = {n: distributed.make_distributed_step(spec, m) for n, m in meshes.items()}
    ms = {"unsharded": [], **{n: [] for n in EXT_DIST_SHARDS}}
    worst = {n: {"y_max_abs": 0.0, "q_rel": 0.0} for n in EXT_DIST_SHARDS}
    one_shard_bitwise = True

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    for t in range(cfg.T):
        state = ogasched.OGAState(y=y, eta=eta, t=t)
        (nxt, q_ref), dt = timed(lambda: ogasched.oga_step(spec, state, arr[t], 1.0,
                                                           backend="auto", operands=operands))
        ms["unsharded"].append(dt)
        for n, step in steps.items():
            shards = distributed.shard_y(y, meshes[n])
            (y_sh, q), dt = timed(lambda: step(shards, arr[t], eta))
            ms[n].append(dt)
            got = distributed.gather_y(y_sh)
            worst[n] = {"y_max_abs": max(worst[n]["y_max_abs"], float((got - nxt.y).abs().max())),
                        "q_rel": max(worst[n]["q_rel"], abs(float(q) - float(q_ref))
                                     / abs(float(q_ref)))}
            if n == 1:
                one_shard_bitwise = one_shard_bitwise and bool(torch.equal(got, nxt.y))
            del shards, y_sh, got
        y = nxt.y
    out = {"config": EXT_DIST_CFG, "rows": [cfg.R * cfg.K, cfg.L], "steps": cfg.T,
           "setup_s": setup_s, "ms_per_step": {str(k): statistics.median(v) for k, v in ms.items()},
           "ms_per_step_all": {str(k): v for k, v in ms.items()},
           "vs_unsharded": {str(k): v for k, v in worst.items()},
           "one_shard_y_bitwise": one_shard_bitwise,
           "feasible": bool(graph.feasible(spec, y)),
           "resident_gb": base_gb, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    # the dry run's scheduler cell at the widest mesh: one position's
    # argument bytes against the tensors a shard of the step holds
    n = max(EXT_DIST_SHARDS)
    t0 = time.perf_counter()
    rec = dryrun.run_sched_cell(mesh=make_mesh((n,), ("data",), ["meta"] * n))
    ADDED_SECONDS["extensions"] = time.perf_counter() - t0
    shard = distributed.shard_spec(spec, meshes[n])[0]
    held = {"spec": sum(getattr(shard, f).nbytes for f in graph.ClusterSpec.FIELDS),
            "y": distributed.shard_y(y, meshes[n])[0].nbytes, "x": arr[0].nbytes,
            "eta": eta.nbytes}
    out["dryrun"] = {"shards": n, "argument_parts": rec["argument_parts"], "held": held,
                     "memory": rec["memory"], "cost": rec["cost"],
                     "collectives": rec["collectives"],
                     "equal": rec["argument_parts"] == held
                     and rec["memory"]["argument_size_in_bytes"] == sum(held.values()),
                     "seconds": ADDED_SECONDS["extensions"]}
    del shard
    return out


def multi_errors(multi: dict, ref: dict) -> dict:
    """§3.4 against its pins (over as many of the pinned slots as
    ``multi`` ran): whether J is equal, the first pinned slot whose reward
    parts from the reference's by more than TRAJ_TOL of the
    prefix's largest (None: none), and the relative errors of the average
    over the slots before it and of the whole run's average."""
    n = min(len(multi["rewards"]), EXT_MULTI_PREFIX)
    prefix, got = unpack_floats(ref["prefix"])[:n], multi["rewards"][:n]
    parted = np.nonzero(np.abs(got - prefix) > TRAJ_TOL * np.abs(prefix).max())[0]
    held = int(parted[0]) if parted.size else len(prefix)
    return {"multi_J_equal": multi["J"] == ref["J"],
            "multi_first_parted_slot": int(parted[0]) if parted.size else None,
            "multi_prefix_avg_reward": metric_error(float(got[:held].mean()),
                                                    float(prefix[:held].mean())),
            "multi_avg_reward": metric_error(multi["avg_reward"], ref["avg_reward"])}


def gang_errors(gang: dict, ref: dict) -> dict:
    """§3.5 against its pins: the relative error of Σ q_t and the first
    slot whose kept-port mask differs (None: none)."""
    want_kept = unpack_events(ref["kept"], gang["kept"].shape)
    bad = np.nonzero((want_kept != gang["kept"]).any(-1))[0]
    return {"gang_sum_q": metric_error(gang["sum_q"], ref["sum_q"]),
            "gang_first_kept_diff": int(bad[0]) if bad.size else None}


def extension_errors(multi: dict, gang: dict, jobs: dict, ref: dict) -> dict:
    """The port's readings of (a), (b) and (d) against their pins (the
    grants and meshes of (d) must be equal)."""
    return {**multi_errors(multi, ref["multi"]), **gang_errors(gang, ref["gang"]),
            "jobs_grants_equal": jobs["grants"] == ref["jobs"]["grants"],
            "jobs_meshes_equal": jobs["meshes"] == ref["jobs"]["meshes"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 3
    if sys.argv[1:2] == ["--resume-worker"]:
        # the resume phase's subprocess (this script's own worker mode)
        ckpt_dir, out_path, speed = sys.argv[2:5]
        return resume_worker(ckpt_dir, out_path, speed == "slow")
    if sys.argv[1:2] == ["--faults-worker"]:
        # the faults phase's subprocesses, one a regime
        return faults_worker(*sys.argv[2:4])
    with tempfile.TemporaryDirectory(prefix="repro-torch-autotune-") as cache_dir:
        # a fresh autotune table: no earlier run's winners decide what runs
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_dir
        device = smoke(torch)
    # the last line, printed only once every phase passed and the run's
    # temporary files are gone: exit code 0 goes with it and with nothing else
    emit({"ok": True, "device": device})
    return 0


def lint_phase() -> dict:
    """The port's lint over the port and this script, in the checkout the
    kernels are built from; raises on any finding."""
    from repro_torch.analysis import lint

    t0 = time.perf_counter()
    paths = [os.path.join(ROOT, "src", "repro_torch"), os.path.join(ROOT, "chip_smoke.py")]
    files = list(lint.iter_py_files(paths))
    findings = lint.lint_paths(paths)
    seconds = time.perf_counter() - t0
    check(not findings, "the port's lint found:\n" + lint.render_text(findings))
    check(seconds <= LINT_SECONDS_BAR, f"the lint took {seconds:.2f} s")
    return {"phase": "lint", "files": len(files), "rules": sorted(lint.RULES),
            "findings": len(findings), "seconds": seconds}


def smoke(torch) -> dict:
    """Every phase; raises on the first failed check. Returns the device
    entry of the last line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import compat
    from repro_torch.analysis import roofline as rl
    from repro_torch.core import ogasched
    from repro_torch.device import gpu_name_and_power_limit, platform_info
    from repro_torch.kernels import _launch, autotune, build, ops, ref
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import oga_step as og_kernel
    from repro_torch.kernels import proj_bisect as pb_kernel
    from repro_torch.kernels import sortscan as ss_kernel
    from repro_torch.sched import simulator, sweep, trace

    autotune.reset_cache()
    autotune.reset_stats()
    check(autotune.lookup("oga_step", 768, 10) is None, "the autotune cache is not empty")

    # full float32 matmuls and convolutions (no TF32), and bf16 matmuls
    # whose split-K partial sums are not reduced in bf16 (cuBLAS may do so
    # by default): the LM phases hold float32 and bf16 paths to tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = gpu_name_and_power_limit()
    check(smi is not None, "nvidia-smi is missing")
    print(smi, flush=True)
    emit({"phase": "platform", **platform_info()})
    emit(lint_phase())
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    shutil.rmtree(build.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    with compat.CompilationCounter() as compiled:
        per_source = build.build()
    build_s = time.perf_counter() - t0
    check(set(per_source) == set(build.SOURCES), f"not every source was built: {per_source}")
    check(compiled.supported and compiled.count == len(build.SOURCES),
          f"the build ran {compiled.count} nvcc for {len(build.SOURCES)} sources")
    ptxas = {}
    for src in build.SOURCES:
        log = build.library_path(src).with_suffix(".log").read_text()
        ptxas[src] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "Compiling entry" in ln or "stack frame" in ln]
    # the float32 flash kernel: one instantiation per head dim; none may
    # spill at hd 128, the path's
    flash_build = flash_f32_build(ptxas_by_kernel(
        build.library_path("flash_attention.cu").with_suffix(".log").read_text()))
    # the flash backward kernels: registers, spills and SASS by
    # instantiation; none spills or touches local memory, and every bf16
    # dK/dV and dQ kernel runs on wgmma fed by TMA
    bwd_lib = build.library_path("flash_attention_bwd.cu")
    flash_bwd_build = flash_bwd_kernels(ptxas_by_kernel(bwd_lib.with_suffix(".log").read_text()),
                                        sass_ops_by_kernel(str(bwd_lib)))
    # each float32 backward instantiation's dynamic shared memory and ring
    # stages, as its C entry computes them
    layout = build.library("flash_attention_bwd.cu").repro_flash_attention_bwd_f32_layout
    layout.argtypes, layout.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    ffma_bwd = [f"{k}<{hd}>" for hd in autotune.FLASH_HEAD_DIMS
                for k in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")]
    for label in ffma_bwd:
        hd = int(label.split("<")[1].rstrip(">"))
        if label in flash_bwd_build:
            flash_bwd_build[label].update({"smem_bytes": layout(hd, int("dq_kernel" in label)),
                                           "stages": layout(hd, 2)})
    emit({"phase": "build", "seconds": build_s, "per_source_s": per_source,
          "compiles": compiled.count,
          "flags": list(build.NVCC_FLAGS), "ptxas": ptxas, "flash_f32_kernels": flash_build,
          "flash_bwd_kernels": flash_bwd_build})
    check(sorted(flash_build) == sorted(autotune.FLASH_HEAD_DIMS),
          f"float32 flash instantiations built: {sorted(flash_build)}")
    check(flash_build[128]["stack_bytes"] == flash_build[128]["spill_store_bytes"]
          == flash_build[128]["spill_load_bytes"] == 0,
          f"the float32 flash kernel spills at hd 128: {flash_build[128]}")
    wgmma_bwd = [f"{k}<{hd}>" for hd in autotune.FLASH_HEAD_DIMS
                 for k in ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")]
    check(all(k in flash_bwd_build for k in wgmma_bwd),
          f"bf16 backward instantiations built: {sorted(flash_bwd_build)}")
    # every float32 dK/dV and dQ instantiation is fed by TMA
    check(all(k in flash_bwd_build for k in ffma_bwd),
          f"float32 backward instantiations built: {sorted(flash_bwd_build)}")
    for label, ent in flash_bwd_build.items():
        check(ent["stack_bytes"] == ent["spill_store_bytes"] == ent["spill_load_bytes"]
              == ent["LDL"] == ent["STL"] == 0, f"{label} spills or touches local memory: {ent}")
        check(label not in wgmma_bwd or (ent["HGMMA"] > 0 and ent["UTMALDG"] > 0),
              f"{label} is not on wgmma fed by TMA: {ent}")
        check(label not in ffma_bwd or ent["UTMALDG"] > 0,
              f"{label} is not fed by TMA: {ent}")
    # the sortscan kernels of L <= 256 work in registers and shuffles: no
    # shared memory, no barrier; no projection kernel spills at any width
    # or touches local memory
    oga_lib = build.library_path("oga_step.cu")
    oga_ptxas = ptxas_by_kernel(oga_lib.with_suffix(".log").read_text())
    oga_sass = sass_ops_by_kernel(str(oga_lib))
    sortscan_build, wide_build = {}, {}
    for name, rep in oga_ptxas.items():
        wide = next((k for k in SORTSCAN_WIDE_KERNELS if k in name), None)
        if wide is not None:
            wide_build[wide] = {**rep, "sass": {op: oga_sass[name][op]
                                                for op in SASS_OPS + ("total",)}}
            continue
        layout = sortscan_layout_of(name)
        if layout is None:
            continue
        kern, W, E = layout
        ent = sortscan_build[f"{kern}<{W},{E}>"] = {
            **rep, "sass": {op: oga_sass[name][op] for op in SASS_OPS + ("total",)}}
        check(rep["smem_bytes"] == 0 and rep["barriers"] == 0
              and ent["sass"]["BAR"] == ent["sass"]["LDS"] == ent["sass"]["STS"] == 0,
              f"{kern}<{W},{E}> uses shared memory or a barrier: {ent}")
    check(len(sortscan_build) == SORTSCAN_INSTANTIATIONS,
          f"sortscan instantiations built: {sorted(sortscan_build)}")
    check(sorted(wide_build) == sorted(SORTSCAN_WIDE_KERNELS),
          f"wide sortscan kernels built: {sorted(wide_build)}")
    # the bisect kernels: the narrow ones in registers and shuffles as the
    # sortscan's; the wide ones with one barrier a row sum
    bisect_lib = build.library_path("proj_bisect.cu")
    bisect_ptxas = ptxas_by_kernel(bisect_lib.with_suffix(".log").read_text())
    bisect_sass = {**oga_sass, **sass_ops_by_kernel(str(bisect_lib))}
    bisect_build, bisect_wide_build = {}, {}
    for name, rep in {**oga_ptxas, **bisect_ptxas}.items():
        layout = bisect_layout_of(name)
        if layout is None:
            continue
        kern, dtype, W, Q = layout
        ent = {**rep, "sass": {op: bisect_sass[name][op] for op in SASS_OPS + ("total",)}}
        label = f"{kern}<{dtype},{W},{Q}>"
        if W > autotune.WARP:
            bisect_wide_build[label] = ent
            continue
        bisect_build[label] = ent
        check(rep["smem_bytes"] == 0 and rep["barriers"] == 0
              and ent["sass"]["BAR"] == ent["sass"]["LDS"] == ent["sass"]["STS"] == 0,
              f"{label} uses shared memory or a barrier: {ent}")
    check(len(bisect_build) == BISECT_INSTANTIATIONS,
          f"bisect instantiations built: {sorted(bisect_build)}")
    check(len(bisect_wide_build) == BISECT_WIDE_INSTANTIATIONS,
          f"wide bisect instantiations built: {sorted(bisect_wide_build)}")
    for name, rep in {**oga_ptxas, **bisect_ptxas}.items():
        check(rep["stack_bytes"] == rep["spill_store_bytes"] == rep["spill_load_bytes"] == 0,
              f"{name} spills: {rep}")
    check(all(ent["sass"]["LDL"] == ent["sass"]["STL"] == 0
              for ent in [*sortscan_build.values(), *wide_build.values(),
                          *bisect_build.values(), *bisect_wide_build.values()]),
          "a projection kernel reads or writes local memory")

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

    def kernel_bytes(kernel, N, L):
        return int(rl.kernel_cost_model(kernel, N, L)["bytes"])

    def feasible(y, a, m, c):
        """Largest violation of 0 <= y <= a, y = 0 on masked lanes and
        sum(y) <= c; raises past CAPACITY_SLACK on the sum."""
        over = float(((y * m).sum(1) - c).max())
        check(bool((y >= 0).all() and (y <= a).all() and (y[m == 0] == 0).all()),
              "a bisection left the box or a masked lane")
        check(over <= CAPACITY_SLACK, f"a bisection overshoots the capacity by {over}")
        return over

    empty = _launch.c_entry("oga_step.cu", "repro_empty_launch",
                            (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))

    def floor_ms(N, L, rb, method="sortscan"):
        """Device time of an empty kernel on the grid of a launch of N rows
        of width L, rb rows per block: the floor under that launch."""
        blocks, threads = -(-N // rb), autotune.block_threads(rb, L, method)
        return time_ms(lambda: _launch.call(empty, dev, blocks, threads))

    def by_row_block(fn, N, L):
        """ms and launch floor at every row block legal for sortscan."""
        rbs = [rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L)]
        return ({rb: time_ms(lambda: fn(rb)) for rb in rbs},
                {rb: floor_ms(N, L, rb) for rb in rbs})

    # the main path's shapes, then the stream path's: the slot stream's
    # chunk of 256, the lifecycle stream's 32, the regret grid's 16 and the
    # host-trace stream's 16 Fig. 2 configs
    shapes = {"fig2": (768, 10), "fig5": (6144, 100), "grid64": (49152, 10),
              "stream": (16384, 6), "stream_lifecycle": (2048, 6), "regret_stream": (1024, 6),
              "stream_host": (12288, 10)}
    proj_shapes = {"fig2": (768, 10), "fig5": (6144, 100), "stream_lifecycle": (2048, 6),
                   "regret_stream": (1024, 6)}
    oga_rows = {}
    for i, (label, (N, L)) in enumerate(shapes.items()):
        args = step_inputs(np.random.default_rng(seeds[i]), N, L)
        got = ops.oga_step_fused(*args)
        want = ref.oga_step_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= OGA_STEP_ATOL, f"oga_step_fused {label} max abs err {err}")
        t_b, by = rl.kernel_bound("oga_step", N, L)
        oga_rows[label] = {
            "N": N, "L": L, "max_abs_err": err,
            "ms": time_ms(lambda: ops.oga_step_fused(*args)),
            "plain_ms": time_ms(lambda: ref.oga_step_ref(*args)),
            "call_ms": call_ms(lambda: ops.oga_step_fused(*args)),
            "plain_call_ms": call_ms(lambda: ref.oga_step_ref(*args)),
            "bound_ms": t_b, "bound_by": by, "bytes": kernel_bytes("oga_step", N, L),
            "launch_floor_ms": floor_ms(N, L, autotune.DEFAULT_ROW_BLOCK),
        }
        oga_rows[label]["ms_by_row_block"], oga_rows[label]["launch_floor_ms_by_row_block"] = \
            by_row_block(lambda rb: og_kernel.oga_step_fused(*args, row_block=rb), N, L)
    # the extensions path's shapes: §3.4 (R*K, L*J), §3.5 (R*K, L*Q), the
    # job manager's (384, 4) and §3.2's on 1 and 4 shards; their operands
    # stay for the autotune phase's tuned times
    ext_args, ext_rows = {}, {}
    for label, (N, L) in EXT_SHAPES.items():
        args = ext_args[label] = step_inputs(np.random.default_rng([20261017, 4, N, L]), N, L)
        plain = lambda: plain_rows(ref.oga_step_ref, args)
        got = ops.oga_step_fused(*args)
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        del got, want
        check(err <= OGA_STEP_ATOL, f"oga_step_fused {label} max abs err {err}")
        t_b, by = rl.kernel_bound("oga_step", N, L)
        plain_reps = EXT_PLAIN_REPS if N >= PLAIN_CHUNK_ROWS else TIMING_REPS
        ext_rows[label] = {
            "N": N, "L": L, "max_abs_err": err,
            "ms": time_ms(lambda: ops.oga_step_fused(*args)),
            "plain_ms": autotune.device_time_ms(plain, plain_reps), "plain_reps": plain_reps,
            "plain_row_block": min(N, PLAIN_CHUNK_ROWS),
            "bound_ms": t_b, "bound_by": by, "bytes": kernel_bytes("oga_step", N, L),
            "launch_floor_ms": floor_ms(N, L, autotune.DEFAULT_ROW_BLOCK),
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
        t_b, by = rl.kernel_bound("oga_step", N, L, "bisect", bisect_pin.iters)
        oga_bisect_rows[label] = {
            "N": N, "L": L, "iters": bisect_pin.iters, "max_abs_err": err,
            "vs_sortscan_max_abs": err_sortscan,
            "ms": time_ms(lambda: ops.oga_step_fused(*args, tiling=bisect_pin)),
            "plain_ms": time_ms(lambda: ref.oga_step_ref(*args, proj="bisect",
                                                         iters=bisect_pin.iters)),
            "bound_ms": t_b, "bound_by": by,
            "launch_floor_ms": floor_ms(N, L, bisect_pin.row_block, "bisect"),
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
        t_b, by = rl.kernel_bound("proj", N, L, "bisect", autotune.DEFAULT_BISECT_ITERS, n_need)
        bisect_rows[label] = {
            "N": N, "L": L, "iters": autotune.DEFAULT_BISECT_ITERS, "rows_binding": n_need,
            "max_abs_err": err, "oracle_err": oracle_err, "capacity_overshoot": overshoot,
            "ms": time_ms(lambda: ops.proj_bisect(*args)),
            "plain_ms": time_ms(lambda: ref.proj_rows_bisect(*args)),
            "call_ms": call_ms(lambda: ops.proj_bisect(*args)),
            "plain_call_ms": call_ms(lambda: ref.proj_rows_bisect(*args)),
            "bound_ms": t_b, "bound_by": by, "bytes": kernel_bytes("proj", N, L),
            "launch_floor_ms": floor_ms(N, L, autotune.DEFAULT_ROW_BLOCK, "bisect"),
        }
    proj_rows = {}
    # the shapes the paths run it at: the regret oracle's (768, 10), (6144,
    # 100) where the autotune path tunes it, and the stream path's
    for i, (label, (N, L)) in enumerate(proj_shapes.items()):
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
        t_b, by = rl.kernel_bound("proj", N, L)
        proj_rows[label] = {
            "N": N, "L": L, "max_abs_err": err, "oracle_err": oracle_err,
            "plain_oracle_err": plain_oracle_err,
            "ms": time_ms(lambda: ops.proj_sortscan(*args)),
            "plain_ms": time_ms(lambda: ref.proj_rows_sorted(*args)),
            "call_ms": call_ms(lambda: ops.proj_sortscan(*args)),
            "plain_call_ms": call_ms(lambda: ref.proj_rows_sorted(*args)),
            "bound_ms": t_b, "bound_by": by, "bytes": kernel_bytes("proj", N, L),
            "launch_floor_ms": floor_ms(N, L, autotune.DEFAULT_ROW_BLOCK),
        }
        proj_rows[label]["ms_by_row_block"], proj_rows[label]["launch_floor_ms_by_row_block"] = \
            by_row_block(lambda rb: ss_kernel.proj_sortscan(*args, row_block=rb), N, L)
    # the wide rows: one block a row, slots in shared memory (row block 1)
    wide_rows = {}
    for L in WIDE_LS:
        N = WIDE_ROWS
        rng = np.random.default_rng([20261017, 2, L])
        z, a, m, c = proj_inputs(rng, N, L, loose_every=5)
        c[1::7] = 0.0            # zero capacity
        z[2::7] = 0.0            # nothing asked
        args = cuda(z, a, m, c)
        got = ops.proj_sortscan(*args)
        y = got.cpu().numpy()
        # the plain version on CPU copies: on the card its float32 sort and
        # cumsum over up to 8192 slots lose ~1e-3 at L = 4096 (the kernel
        # equals the float64 oracle there)
        plain = ref.proj_rows_sorted(*map(torch.from_numpy, (z, a, m, c))).numpy()
        sample = np.unique(np.r_[np.arange(WIDE_ORACLE_ROWS // 2),
                                 np.arange(1, N, 7)[:WIDE_ORACLE_ROWS // 4],
                                 np.arange(2, N, 7)[:WIDE_ORACLE_ROWS // 4]])
        oracle_err = float(np.abs(y[sample] - ref.proj_rows_exact_np(
            z[sample], a[sample], m[sample], c[sample])).max())
        err = float(np.abs(y - plain).max())
        zeros_exact = bool((y[1::7] == 0.0).all() and (y[2::7] == 0.0).all())
        check(oracle_err <= PROJ_ATOL, f"proj_sortscan L={L} vs float64 oracle {oracle_err}")
        check(err <= PROJ_PLAIN_ATOL, f"proj_sortscan L={L} vs plain {err}")
        check(zeros_exact, f"proj_sortscan L={L}: zero-capacity or zero rows not exactly 0")
        sargs = step_inputs(rng, N, L)
        sargs[-1][1::7, 2] = 0.0
        step = ops.oga_step_fused(*sargs)
        step_err = float((step.cpu() - ref.oga_step_ref(*(t.cpu() for t in sargs))).abs().max())
        check(step_err <= OGA_STEP_ATOL, f"oga_step_fused L={L} vs plain {step_err}")
        check(bool((step[1::7] == 0.0).all()), f"oga_step_fused L={L}: zero-capacity rows not 0")
        bis = ops.proj_bisect(*args)
        bis_err = float((bis - ref.proj_rows_bisect(*args)).abs().max())
        check(bis_err <= BISECT_ATOL, f"proj_bisect L={L} vs plain {bis_err}")
        feasible(bis.cpu().numpy(), a, m, c)
        step_bis = ops.oga_step_fused(*sargs, tiling=bisect_pin)
        step_bis_err = float((step_bis - ref.oga_step_ref(*sargs, proj="bisect")).abs().max())
        check(step_bis_err <= BISECT_ATOL, f"oga_step_fused bisect L={L} vs plain {step_bis_err}")
        n_need = int(((np.clip(z, 0.0, a) * m).sum(1) > c).sum())
        t_p, by_p = rl.kernel_bound("proj", N, L)
        t_s, by_s = rl.kernel_bound("oga_step", N, L)
        t_b, by_b = rl.kernel_bound("proj", N, L, "bisect", autotune.DEFAULT_BISECT_ITERS, n_need)
        wide_rows[str(L)] = {
            "N": N, "L": L, "slots": autotune.slots_for(L),
            "threads": autotune.row_threads(L),
            "smem_bytes": autotune.slots_for(L) * 12 + 8 * autotune.WIDE_THREADS // autotune.WARP,
            "rows_binding": n_need,
            "proj_sortscan": {"max_abs_err": err, "oracle_err": oracle_err,
                              "oracle_rows": len(sample), "zeros_exact": zeros_exact,
                              "ms": time_ms(lambda: ops.proj_sortscan(*args)),
                              "plain_ms": time_ms(lambda: ref.proj_rows_sorted(*args)),
                              "bound_ms": t_p, "bound_by": by_p},
            "oga_step_fused": {"max_abs_err": step_err,
                               "ms": time_ms(lambda: ops.oga_step_fused(*sargs)),
                               "plain_ms": time_ms(lambda: ref.oga_step_ref(*sargs)),
                               "bound_ms": t_s, "bound_by": by_s},
            "proj_bisect": {"max_abs_err": bis_err,
                            "ms": time_ms(lambda: ops.proj_bisect(*args)),
                            "plain_ms": time_ms(lambda: ref.proj_rows_bisect(*args)),
                            "bound_ms": t_b, "bound_by": by_b},
            "oga_step_fused_bisect": {"max_abs_err": step_bis_err,
                                      "ms": time_ms(lambda: ops.oga_step_fused(
                                          *sargs, tiling=bisect_pin))},
            "launch_floor_ms": floor_ms(N, L, 1),
        }
    # proj_bisect against the emulation of its sums' order, bit for bit, at
    # one row per block and at the largest legal block
    bisect_network = {}
    for L in BISECT_NETWORK_LS:
        N = BISECT_NETWORK_ROWS
        z, a, m, c = proj_inputs(np.random.default_rng([20261017, 3, L]), N, L, loose_every=3)
        c[5] = 0.0               # zero capacity
        z[7] = 0.0               # nothing asked
        want = bisect_network_project(z, a, m, c, autotune.DEFAULT_BISECT_ITERS)
        args = cuda(z, a, m, c)
        big = max(rb for rb in autotune.ROW_BLOCKS if autotune.legal_row_block(rb, L, "bisect"))
        for rb in (1, big):
            got = pb_kernel.proj_bisect(*args, row_block=rb).cpu().numpy()
            differ = int((got != want).any(1).sum())
            check(differ == 0, f"proj_bisect L={L} row_block={rb}: {differ} rows differ "
                               f"from the emulation, max {float(np.abs(got - want).max())}")
        check(bool((want[5] == 0.0).all() and (want[7] == 0.0).all()),
              f"proj_bisect L={L}: zero-capacity or zero rows not exactly 0")
        bisect_network[str(L)] = {"rows": N, "row_blocks": [1, big], "bitwise_equal": True,
                                  "rows_binding": int(((np.clip(z, 0.0, a) * m).sum(1) > c).sum())}
    emit({"phase": "kernels", "row_block": autotune.DEFAULT_ROW_BLOCK,
          "oga_step_fused": oga_rows, "oga_step_fused_extensions": ext_rows,
          "oga_step_fused_bisect": oga_bisect_rows,
          "proj_sortscan": proj_rows, "proj_bisect": bisect_rows,
          "wide_rows": wide_rows,
          "bisect_network": bisect_network,
          "sortscan_kernels_build": sortscan_build, "wide_kernels_build": wide_build,
          "bisect_kernels_build": bisect_build, "bisect_wide_kernels_build": bisect_wide_build,
          "oga_step_atol": OGA_STEP_ATOL, "proj_atol": PROJ_ATOL,
          "proj_plain_atol": PROJ_PLAIN_ATOL, "bisect_atol": BISECT_ATOL,
          "timing": f"ms: device time, median of {TIMING_REPS} back-to-back calls "
                    f"between CUDA events behind a GPU spin; call_ms: host time of "
                    f"one call to completion, median of {TIMING_REPS}; launch_floor_ms: "
                    f"an empty kernel on the launch's grid, timed the same way"})
    flash = flash_phase(torch, dev)
    emit(flash)
    emit(reduced_lm_phase(torch, dev))

    # ------------------------------------------------------------- autotune
    # one count per CUDA kernel; both flash kernels sit behind one wrapper,
    # which counts each under its dtype
    names = ("oga_step_fused", "proj_sortscan", "proj_bisect", "flash_attention_bf16",
             "flash_attention_f32", "flash_attention_bwd_bf16", "flash_attention_bwd_f32")
    wrappers = (og_kernel.oga_step_fused, ss_kernel.proj_sortscan, pb_kernel.proj_bisect)
    flash_counts = fa_kernel.flash_attention.kernel_launches
    # the backward wrapper counts its calls and, by dtype, the kernels they
    # launch (three a call)
    bwd_counts = fa_kernel.flash_attention_bwd.kernel_launches

    def zero_launches():
        for w in wrappers:
            w.launches = 0
        for w in wrappers[:2]:
            w.launches_by_shape.clear()
        fa_kernel.flash_attention.launches = 0
        fa_kernel.flash_attention_bwd.launches = 0
        for counts_ in (flash_counts, bwd_counts):
            for key in counts_:
                counts_[key] = 0

    def launches():
        return tuple(w.launches for w in wrappers) + (
            flash_counts["bf16"], flash_counts["float32"], bwd_counts["bf16"],
            bwd_counts["float32"])

    zero_launches()
    t0 = time.perf_counter()
    default_label = autotune.DEFAULT_CONFIG._replace(iters=0).label
    tuned = {}
    for label, (N, L) in {**shapes, **EXT_SHAPES}.items():
        win, measured = autotune.tune("oga_step", N, L)
        check(autotune.lookup("oga_step", N, L) == win, f"oga_step {label}: winner not stored")
        # the bisect A/B at the winner's row block: both methods take the
        # same row blocks
        ab_rb = win.row_block
        ab_cands = [autotune.KernelConfig(ab_rb, "bisect", it) for it in autotune.BISECT_ITERS]
        _, ab = autotune.tune("oga_step", N, L, cands=ab_cands, store=False)
        tuned[label] = {
            "N": N, "L": L, "us": measured, "winner": win.label,
            "speedup_vs_default": measured[default_label] / measured[win.label],
            "bisect_row_block": ab_rb, "bisect_us": ab,
            "bisect_over_sortscan": {k: v / measured[win.label] for k, v in ab.items()},
        }
    # the extensions path's shapes at their winners: time and launch floor
    for label, (N, L) in EXT_SHAPES.items():
        args, rb = ext_args.pop(label), autotune.lookup("oga_step", N, L).row_block
        ext_rows[label].update({"tuned_row_block": rb,
                                "tuned_ms": time_ms(lambda: ops.oga_step_fused(*args)),
                                "tuned_launch_floor_ms": floor_ms(N, L, rb)})
        del args
    tuned_proj = {}
    for label, (N, L) in proj_shapes.items():
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
    for name, n in zip(names[:3], tune_launches):
        check(n > 0, f"{name} was not launched on the autotune path")
    # every legal row block of the four projection kernels (both methods,
    # fused and standalone) gives the bits of one block per row, at every
    # tuned shape and at a ragged row count
    bitwise = {}
    rngs = {label: (lambda i=i: np.random.default_rng(seeds[i]))
            for i, label in enumerate(shapes)}
    rngs.update({label: (lambda N=N, L=L: np.random.default_rng([20261017, 5, N, L]))
                 for label, (N, L) in EXT_SHAPES.items()})
    for label, (N, L) in {**shapes, **EXT_SHAPES}.items():
        for n in (N, N - 5):
            sargs = step_inputs(rngs[label](), n, L)
            sargs[-1][::3, 2] = 1e4  # the capacity binds on two rows in three
            pargs = cuda(*proj_inputs(np.random.default_rng(seeds[4]), n, L, loose_every=3))
            runs = {
                "oga_step_fused": lambda rb: og_kernel.oga_step_fused(*sargs, row_block=rb),
                "proj_sortscan": lambda rb: ss_kernel.proj_sortscan(*pargs, row_block=rb),
                "oga_step_fused_bisect": lambda rb: og_kernel.oga_step_fused(
                    *sargs, method="bisect", row_block=rb),
                "proj_bisect": lambda rb: pb_kernel.proj_bisect(*pargs, row_block=rb),
            }
            base = {k: run(1) for k, run in runs.items()}
            rbs = [c.row_block for c in autotune.candidates("oga_step", n, L)]
            check(set(rbs) == {c.row_block for c in autotune.candidates(
                "oga_step", n, L, methods=("bisect",))}, f"row blocks differ at ({n}, {L})")
            for rb in rbs[1:]:
                same = {k: torch.equal(run(rb), base[k]) for k, run in runs.items()}
                check(all(same.values()), f"row_block={rb} changes the bits at ({n}, {L}): {same}")
            bitwise[f"{n}x{L}"] = rbs
    emit({"phase": "autotune", "cache": "fresh temporary directory",
          "oga_step": tuned, "proj": tuned_proj, "seconds": tune_s,
          "measurements": autotune.measurement_count(),
          "launches": dict(zip(names, tune_launches)),
          "extension_shapes_tuned": {k: {f: r[f] for f in ("N", "L", "tuned_row_block",
                                                            "tuned_ms", "tuned_launch_floor_ms")}
                                     for k, r in ext_rows.items()},
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
    # the warm-up run under the sync guard: a host sync inside it raises
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with compat.sync_guard("error"):
        guarded, _ = ogasched.run(spec2, sub, eta0=25.0)
    torch.cuda.synchronize()
    guard_s = time.perf_counter() - t0
    check(bool(torch.isfinite(guarded).all()), "fig2: the guarded run's rewards are not finite")
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
            if "oga_step_sortscan_kernel" in ev.key:
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
          "fused_launches": n1[0] - n0[0], "ogasched_slot_profile": slot_profile,
          "sync_guarded_run": {"slots": int(sub.shape[0]), "mode": "error", "seconds": guard_s}})

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
    # the resident rows the stream path's host-trace stream is held to
    grid_rows = {n: out_g[n].cpu().numpy() for n in grid_algorithms}
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
    counts = launches()
    for name, n in zip(names[:2], counts):
        check(n > 0, f"{name} was not launched on the main path")
    main_by_shape = {name: {f"{N}x{L}": n for (N, L), n in sorted(w.launches_by_shape.items())}
                     for name, w in zip(names[:2], wrappers[:2])}
    check(main_by_shape == MAIN_LAUNCHES_BY_SHAPE,
          f"main-path launches by shape: {main_by_shape}")

    # ------------------------------------------------------- lifecycle path
    del batch, spec_g, arr_g, out_g, spec2, arr2, sub
    torch.cuda.empty_cache()
    zero_launches()
    workers = start_faults_workers()
    done = {}
    try:
        lifecycle_phase(torch, dev,
                        beside=lambda: done.setdefault("faults", faults_phase(workers)))
    finally:
        stop_workers(workers)   # a no-op once faults_phase has collected them
    faults = done["faults"]
    grid_lifecycle_phase(torch, dev)
    # the faults workers' launches are the lifecycle path's too
    lifecycle_counts = tuple(n + w for n, w in zip(launches(), faults["launches"]))
    for name, n in zip(names[:2], lifecycle_counts):
        check(n > 0, f"{name} was not launched on the lifecycle path")
    lifecycle_by_shape = {}
    for name, w in zip(names[:2], wrappers[:2]):
        shapes = {f"{N}x{L}": n for (N, L), n in w.launches_by_shape.items()}
        for shape, n in faults["launches_by_shape"].get(name, {}).items():
            shapes[shape] = shapes.get(shape, 0) + n
        lifecycle_by_shape[name] = dict(sorted(shapes.items(),
                                               key=lambda kv: tuple(map(int, kv[0].split("x")))))

    # ---------------------------------------------------------- stream path
    torch.cuda.empty_cache()
    zero_launches()
    autotune.reset_stats()
    stream = stream_phase(torch, dev, points, grid_rows)
    resume_phase(torch, dev)
    regret_line = regret_validation_phase(torch, dev)
    stream_stats = autotune.cache_stats()
    check(stream_stats["measurements"] == 0 and stream_stats["misses"] == 0,
          f"the warmed stream path measured or missed the autotune cache: {stream_stats}")
    stream_counts = launches()
    for name, n in zip(names[:2], stream_counts):
        check(n > 0, f"{name} was not launched on the stream path")
    stream_by_shape = {name: {f"{N}x{L}": n for (N, L), n in sorted(w.launches_by_shape.items())}
                       for name, w in zip(names[:2], wrappers[:2])}

    # ------------------------------------------------------ extensions path
    torch.cuda.empty_cache()
    zero_launches()
    autotune.reset_stats()
    extensions_phase(torch, dev, res2["ogasched"].rewards)
    ext_stats = autotune.cache_stats()
    check(ext_stats["measurements"] == 0 and ext_stats["misses"] == 0,
          f"the warmed extensions path measured or missed the autotune cache: {ext_stats}")
    ext_counts = launches()
    check(ext_counts[0] > 0, "oga_step_fused was not launched on the extensions path")
    ext_by_shape = {name: {f"{N}x{L}": n for (N, L), n in sorted(w.launches_by_shape.items())}
                    for name, w in zip(names[:2], wrappers[:2])}

    # ----------------------------------------------------------- serve path
    torch.cuda.empty_cache()
    zero_launches()
    lm_cfg, lm_params = lm_prefill_phase(torch, dev)
    lm_serve_phase(torch, dev, lm_cfg, lm_params)
    del lm_params
    torch.cuda.empty_cache()
    families = lm_families_phase(torch, dev)
    emit(families)
    serve_counts = launches()
    for name, n in zip(names[3:5], serve_counts[3:5]):
        check(n > 0, f"{name} was not launched on the serve path")

    # ----------------------------------------------------------- train path
    # the backward kernels against their plain version first (launches that
    # compare are not the path's), then the path: the slice at full width,
    # stablelm-3b trained at full width and depth, the reduced configs
    torch.cuda.empty_cache()
    train_kernels = train_kernel_checks(torch, dev)
    emit(train_kernels)
    zero_launches()
    train_slice_check(torch, dev)
    train_full_line = train_full(torch, dev)
    train_reduced_check(torch, dev)
    train_counts = launches()
    for name, n in zip(names[3:], train_counts[3:]):
        check(n > 0, f"{name} was not launched on the train path")

    # ---------------------------------------------------------- kernel line
    paths = {"autotune": tune_launches, "main": counts, "lifecycle": lifecycle_counts,
             "stream": stream_counts, "extensions": ext_counts, "serve": serve_counts,
             "train": train_counts}
    emit({"phase": "paths", "autotune_cache": stats, "stream_autotune_cache": stream_stats,
          "launches": {p: dict(zip(names, c)) for p, c in paths.items()},
          "main_launches_by_shape": main_by_shape,
          "lifecycle_launches_by_shape": lifecycle_by_shape,
          "stream_launches_by_shape": stream_by_shape,
          "extensions_autotune_cache": ext_stats,
          "extensions_launches_by_shape": ext_by_shape,
          "stream_configs_per_s": {"slot": stream["slot"]["configs_per_s"],
                                   "lifecycle": stream["lifecycle"]["configs_per_s"],
                                   "regret_validation": regret_line["configs_per_s"]}})
    csrc = "src/repro_torch/kernels/csrc/"

    def by_path(i):
        """A kernel's launches on each path; "launches" is their sum."""
        return {p: c[i] for p, c in paths.items()}

    def stream_times(rows):
        """A kernel's rows at the stream path's shapes."""
        return {label: {k: r[k] for k in ("N", "L", "max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")}
                for label, r in rows.items() if label.startswith(("stream", "regret"))}

    def wide_times(kernel):
        """A kernel's times at the wide rows, by L."""
        return {L: {k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                for L, r in wide_rows.items()}

    fl, fl32 = flash["path_bf16"]["global"], flash["path_f32"]["global"]
    small = flash["small"]
    kernels = [
        {"name": "oga_step_fused", "route": "cuda", "source": csrc + "oga_step.cu",
         "replaces": "src/repro/kernels/oga_step.py:107",
         "launches": sum(by_path(0).values()),
         "launches_by_path": by_path(0),
         "main_launches_by_shape": main_by_shape["oga_step_fused"],
         "lifecycle_launches_by_shape": lifecycle_by_shape["oga_step_fused"],
         "stream_launches_by_shape": stream_by_shape["oga_step_fused"],
         "extensions_launches_by_shape": ext_by_shape["oga_step_fused"],
         "stream_rows": stream_times(oga_rows),
         "extensions_rows": ext_rows,
         "max_abs_err": max([r["max_abs_err"] for r in [*oga_rows.values(), *ext_rows.values()]]
                            + [r["oga_step_fused"]["max_abs_err"] for r in wide_rows.values()]),
         "ms": oga_rows["fig2"]["ms"], "plain_ms": oga_rows["fig2"]["plain_ms"],
         "bound_ms": oga_rows["fig2"]["bound_ms"], "bound_by": oga_rows["fig2"]["bound_by"],
         "library_ms": None, "wide_rows": wide_times("oga_step_fused")},
        {"name": "proj_sortscan", "route": "cuda", "source": csrc + "oga_step.cu",
         "replaces": "src/repro/kernels/sortscan.py:171",
         "launches": sum(by_path(1).values()),
         "launches_by_path": by_path(1),
         "main_launches_by_shape": main_by_shape["proj_sortscan"],
         "lifecycle_launches_by_shape": lifecycle_by_shape["proj_sortscan"],
         "stream_launches_by_shape": stream_by_shape["proj_sortscan"],
         "extensions_launches_by_shape": ext_by_shape["proj_sortscan"],
         "stream_rows": stream_times(proj_rows),
         "max_abs_err": max([r["max_abs_err"] for r in proj_rows.values()]
                            + [r["proj_sortscan"]["max_abs_err"] for r in wide_rows.values()]),
         "ms": proj_rows["fig2"]["ms"], "plain_ms": proj_rows["fig2"]["plain_ms"],
         "bound_ms": proj_rows["fig2"]["bound_ms"], "bound_by": proj_rows["fig2"]["bound_by"],
         "library_ms": None, "wide_rows": wide_times("proj_sortscan")},
        {"name": "proj_bisect", "route": "cuda", "source": csrc + "proj_bisect.cu",
         "replaces": "src/repro/kernels/proj_bisect.py:89",
         "launches": sum(by_path(2).values()),
         "launches_by_path": by_path(2),
         "max_abs_err": max([r["max_abs_err"] for r in bisect_rows.values()]
                            + [r["proj_bisect"]["max_abs_err"] for r in wide_rows.values()]),
         "ms": bisect_rows["fig2"]["ms"], "plain_ms": bisect_rows["fig2"]["plain_ms"],
         "bound_ms": bisect_rows["fig2"]["bound_ms"], "bound_by": bisect_rows["fig2"]["bound_by"],
         "library_ms": None, "wide_rows": wide_times("proj_bisect")},
        {"name": "flash_attention_bf16", "kernel": "flash_attention_wgmma_kernel",
         "route": "cuda", "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": sum(by_path(3).values()),
         "launches_by_path": by_path(3),
         "max_abs_err": max([r["max_abs_err"] for r in small["bfloat16"]] +
                            [r["max_abs_err"] for r in flash["path_bf16"].values()] +
                            [r["max_abs_err"] for r in flash["families_bf16"].values()]),
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
         "library_ms": flash["library"]["global"]["library_ms"],
         "library_vs_kernel_without_softcap_ms": flash["library"]["global"]["kernel_ms"],
         "window4096": {**{k: flash["path_bf16"]["window4096"][k]
                           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        "library_ms": flash["library"]["window4096"]["library_ms"],
                        "library_vs_kernel_without_softcap_ms":
                            flash["library"]["window4096"]["kernel_ms"]},
         "family_shapes": {arch: {**{k: row[k] for k in (
             "B_S_H_G_hd", "window", "max_abs_err", "max_err_over_bar", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
             "launches": families["bf16_flash_launches"][arch]}
             for arch, row in flash["families_bf16"].items()}},
        {"name": "flash_attention_f32", "kernel": "flash_attention_f32_kernel",
         "route": "cuda", "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": sum(by_path(4).values()),
         "launches_by_path": by_path(4),
         "max_abs_err": max([r["max_abs_err"] for r in small["float32"]] +
                            [r["max_abs_err"] for r in flash["path_f32"].values()]),
         "ms": fl32["ms"], "plain_ms": fl32["plain_ms"],
         "bound_ms": fl32["bound_ms"], "bound_by": fl32["bound_by"],
         "launch_floor_ms": fl32["launch_floor_ms"],
         "library_ms": flash["library_f32"]["global"]["library_ms"],
         "library_vs_kernel_without_softcap_ms": flash["library_f32"]["global"]["kernel_ms"],
         "window4096": {**{k: flash["path_f32"]["window4096"][k]
                           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "launch_floor_ms")},
                        "library_ms": flash["library_f32"]["window4096"]["library_ms"],
                        "library_vs_kernel_without_softcap_ms":
                            flash["library_f32"]["window4096"]["kernel_ms"]}},
    ]
    bwd_path = train_kernels["path"]
    for i, (name, dtype) in enumerate((("flash_attention_bwd_bf16", "bfloat16"),
                                       ("flash_attention_bwd_f32", "float32")), start=5):
        main = bwd_path[f"{TRAIN_ARCH}_{dtype}"]
        rows = train_kernels["small"][dtype] + [r for r in bwd_path.values()
                                                if r["dtype"] == dtype]
        per_call = fa_kernel.BWD_KERNELS["bf16" if dtype == "bfloat16" else "float32"]
        kernels.append({
            "name": name, "kernel": ", ".join(per_call),
            "route": "cuda", "source": csrc + "flash_attention_bwd.cu", "replaces": None,
            "note": "no Pallas counterpart: the gradient of the function of "
                    "src/repro/kernels/flash_attention.py:64, which the reference takes by "
                    "autodiff of its jnp attention",
            "launches": sum(by_path(i).values()), "launches_by_path": by_path(i),
            "launches_per_call": len(per_call),
            "max_abs_err": max(r[g]["kernel_vs_plain"] for r in rows for g in ("dq", "dk", "dv")),
            "max_err_over_bar": max(r["max_err_over_bar"] for r in rows),
            **({"max_abs_err_vs_emulation": max(r[g]["kernel_vs_emulation"] for r in rows
                                                for g in ("dq", "dk", "dv")),
                "library_vs_f32_of_max": main["library"]["vs_f32_of_max"],
                "emulation_vs_f32_of_max": main["emulation_vs_f32_of_max"]}
               if dtype == "bfloat16" else {}),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["B_S_H_G_hd"],
            "gemma2_27b_shapes": {label: {k: r[k] for k in (
                "B_S_H_G_hd", "window", "softcap", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "kernel_without_softcap_ms")}
                for label, r in bwd_path.items()
                if label.startswith("gemma2") and r["dtype"] == dtype}})
    # the train path's launches that phase train's part "mesh" made (the
    # pipelines), within launches_by_path["train"]
    for ent in kernels[3:]:
        ent["train_mesh_launches"] = train_full_line["mesh"]["launches"][ent["name"]]
    kernels[5]["train_step"] = {k: train_full_line[k] for k in (
        "ms_per_step", "tokens_per_s", "peak_memory_gb")}
    kernels[5]["train_step"]["flash_bwd_share_of_step"] = \
        train_full_line["profile"]["flash_bwd_share_of_step"]
    # no phase after build compiled a kernel (the faults workers checked
    # their own count); the added parts' seconds against their budget
    later = compat.backend_compile_count() - compiled.count
    emit({"phase": "added_parts", "seconds": ADDED_SECONDS,
          "total_s": sum(ADDED_SECONDS.values()), "budget_s": ADDED_PARTS_BUDGET_S,
          "compiles_after_build": later})
    check(later == 0, f"{later} kernel compiles after the build phase")
    emit({"kernels": kernels})
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


if __name__ == "__main__":
    sys.exit(main())
