#!/usr/bin/env python3
"""What each piece of the flash kernels buys, on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/flash_ablation.py [--parent DIR] [--only A,B]
    python3 tools/flash_ablation.py --bwd [--parent DIR] [--only A,B]

Forward (the default). Builds src/repro_torch/kernels/csrc/flash_attention.cu as it is
("kernel") and variants made from it by text edits, each with nvcc into
its own library (all at once), and times the bf16 kernel of each bf16
variant and the float32 kernel of each float32 variant at gemma2-27b's
prefill shape (1, 8192, 32, 16, 128): softcap 50 global and with window
4096, and no softcap, in turns (every variant, then again in reverse
order; each time the median of 20 calls between CUDA events). With
``--parent DIR`` (a checkout of another commit, unpacked by ``git
archive`` into a git-ignored directory such as ``build/``) its
flash_attention.cu is built too, against its own csrc/hopper.cuh, as the
variant "parent" of both dtypes, so the two kernels of each dtype are timed
in turns in one call (change, parent, parent, change) and compared bit for
bit; ``--only parent`` builds and times those alone. The parent's C
entries must take the row log-sum-exp pointer beside o, as these do.

bf16 variants (the tensor-core kernel):

  one_kv_barrier  K and V of a stage share one "empty" barrier, freed after
                  P V (the producer then loads K_{t+1} only after P V_{t-1})
  no_pingpong     the named-barrier turns removed: both warpgroups issue
                  their products whenever they are ready
  stages3         three K/V stages in shared memory instead of two
  tanhf_always    every warp calls tanhf (ex2 + rcp + polynomial, branch-free)
  one_chain       the softmax's row maxima and sums as one dependent chain
  gemm_only       the softmax replaced by a scaling of S: the products and
                  the feeding alone (a diagnostic; its output is wrong)
  softmax_only    no wgmma issued: S made up from a descriptor bit, P folded
                  into O by one add; the softmax and the feeding alone (a
                  diagnostic; its output is wrong)
  softmax_only_no_exp  the same with the ex2 of p replaced by a multiply
                  (a diagnostic: the softmax without its special-function op)
  no_loads        the producer arrives on the full barriers without loading
                  K or V (a diagnostic: the kernel on stale tiles)
  cond_rescale    O *= alpha skipped when every alpha of the warp is 1

float32 variants (the FFMA kernel; its "no softcap" is the no_softcap
column of every variant):

  f32_gemm_only   the softmax replaced by a scaling of S: the two products,
                  the P tile and the loads alone (a diagnostic)
  f32_softmax_only  S from one 4-column step of Q K^T instead of hd / 4, and
                  P folded into O by one add a key instead of P V: the
                  softmax, the P tile and the loads alone (a diagnostic)
  f32_stages1     one K/V stage instead of the ring of two: tile t is asked
                  for in turn t, so no load overlaps the products

Every variant is checked against the plain version at small shapes (the
bars of chip_smoke.py) and, at the path shape, bit for bit against
"kernel": all but the diagnostics (gemm_only, softmax_only,
softmax_only_no_exp, no_loads, f32_gemm_only, f32_softmax_only) and
one_chain (which sums l in another order) keep the arithmetic. Prints one
JSON line, and the card's name, power limit and SM clock. Needs no
network.

Backward (``--bwd``): the float32 gradient kernels of
csrc/flash_attention_bwd.cu the same way, at chip_smoke.py's three
BWD_PATH_SHAPES (stablelm-3b; gemma2-27b global and with window 4096, both
with softcap 50, and the global one also without it): each variant's
float32 instantiations' registers and spill bytes, its dq, dk, dv bit for
bit against "kernel" and over chip_smoke's bar (each within
BWD_F32_RTOL_OF_MAX of its largest magnitude of the plain version's), and
its time in turns (median of BWD_REPS calls) with each kernel's device
time from torch.profiler. ``--parent DIR`` builds the parent's
flash_attention_bwd.cu and calls its float32 C entry with the parent's
own tile constants (read from its kernels/autotune.py). Its variants (the
score products' chunk loop, left rolled in the kernel, unrolled):

  bwd_chunks_unrolled  over all 8 of a box's four-column chunks
  bwd_chunks_by2       over 2

The variants are text edits of the kernel's source: each edit must apply
exactly once, and one that no longer does after a change to the kernel
raises ValueError naming it; the variant has to be written anew against
the new source. Build, bar and spill checks of the kernels as shipped are
chip_smoke.py's.
"""
from __future__ import annotations

import ast
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
BWD_SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention_bwd.cu")
OUT = os.path.join(ROOT, "build", "flash_ablation")
REPS = 20
BWD_REPS = 10


def _edit(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"variant edit does not apply exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


# the float32 kernel's softmax call, and the products' inner statements
_F32_SOFTMAX = (
    "    if (whole) {\n"
    "      softmax_tile<false>(s, m, l, alpha, q0, pos_lo, pos_hi, k0 + cl, S, window, scale, cap,\n"
    "                          inv_cap, c);\n"
    "    } else {\n"
    "      softmax_tile<true>(s, m, l, alpha, q0, pos_lo, pos_hi, k0 + cl, S, window, scale, cap,\n"
    "                         inv_cap, c);\n"
    "    }\n")
_F32_QK_BOXES = (
    "#pragma unroll 1\n"
    "  for (int box = 0; box < HD / kBoxCols; ++box) {\n"
    "    qk_box<kBoxCols / 4>(s, q_rows + box * kQBox, k_rows + box * kKVBox, rg, kx);\n"
    "  }\n"
    "  if constexpr (HD % kBoxCols != 0) {\n")
_F32_PV_FMA = "              acc[i][g * C::kVec + x] = fmaf(p, vf[g][x], acc[i][g * C::kVec + x]);\n"


def f32_variants(src: str) -> dict:
    """The float32 kernel's variants (text edits of ``src``)."""
    return {
        "f32_gemm_only": _edit(src, [(_F32_SOFTMAX, (
            "    (void)whole;\n"
            "#pragma unroll\n"
            "    for (int i = 0; i < kMicroRows; ++i) {\n"
            "      alpha[i] = 1.0f;\n"
            "#pragma unroll\n"
            "      for (int j = 0; j < kMicroKeys; ++j) s[i][j] *= 1e-3f;\n"
            "    }\n"))]),
        "f32_softmax_only": _edit(src, [
            (_F32_QK_BOXES, "  qk_box<1>(s, q_rows, k_rows, rg, kx);\n  if constexpr (false) {\n"),
            (_F32_PV_FMA, "              if (g == 0 && x == 0) acc[i][0] += p;\n")]),
        "f32_stages1": _edit(src, [
            ("constexpr int kRing = 2;", "constexpr int kRing = 1;"),
            ("stages != f32::kRing ||", "")]),
    }


def bf16_variants(src: str) -> dict:
    """The bf16 kernel's variants (text edits of ``src``), "kernel" first."""
    turns = [(f'asm volatile("bar.{op} {i}, 256;\\n" ::: "memory");', "")
             for op, i in (("sync", 1), ("sync", 2), ("arrive", 1), ("arrive", 2))]
    gemm_a = src.index("    auto softmax = [&](")
    gemm_b = src.index("    auto k_tile = [&](int t)")
    exp = "    const float p = exp2_ftz(fmaf(s[i], c, -base[(i >> 1) & 1]));\n"
    no_exp = "    const float p = fmaf(s[i], c, -base[(i >> 1) & 1]) * 0.25f;\n"
    v = {
        "kernel": src,
        "one_kv_barrier": _edit(src, [
            ("        mbar_wait(&v_empty[st], free_parity);\n", ""),
            ("    release(k_empty, 0);\n", ""),
            ("      release(k_empty, t);\n", ""),
            ("      release(v_empty, t - 1);", "      release(k_empty, t - 1);"),
            ("    release(v_empty, n_tiles - 1);", "    release(k_empty, n_tiles - 1);")]),
        "no_pingpong": _edit(src, turns),
        "stages3": _edit(src, [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                               ("stages != tc::kStages ||", "")]),
        "tanhf_always": _edit(src, [("if (__all_sync(0xffffffffu, most < 0.6f)) {",
                                     "if (false) {")]),
        "one_chain": _edit(src, [("constexpr int kChains = 4;", "constexpr int kChains = 1;")]),
        "cond_rescale": _edit(src, [(
            "      rescale<HDP>(acc, alpha);\n",
            "      if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {\n"
            "        rescale<HDP>(acc, alpha);\n"
            "      }\n")]),
        "no_loads": _edit(src, [
            ("          tma_load(k_tile + c * kBlockK * kRowBytes, &tm_k, &k_full[st], 64 * c, k0, g, "
             "b);\n", ""),
            ("          tma_load(v_tile + c * kBlockK * kRowBytes, &tm_v, &v_full[st], 64 * c, k0, g, "
             "b);\n", ""),
            ("        mbar_expect_tx(&k_full[st], L::kKV);", "        mbar_arrive(&k_full[st]);"),
            ("        mbar_expect_tx(&v_full[st], L::kKV);", "        mbar_arrive(&v_full[st]);")]),
        "gemm_only": src[:gemm_a] + (
            "    auto softmax = [&](float(&s)[kBlockK / 2], float(&alpha)[2], int) {\n"
            "      alpha[0] = alpha[1] = 1.0f;\n"
            "#pragma unroll\n"
            "      for (int i = 0; i < kBlockK / 2; ++i) s[i] *= 1e-3f;\n"
            "    };\n") + src[gemm_b:],
        "softmax_only": _edit(src, [
            ("    wgmma_ss_k<kBlockK>(s, da, db, kk > 0);\n",
             "    if (kk == 0) {\n"
             "      for (int i = 0; i < kBlockK / 2; ++i)\n"
             "        s[i] = __uint_as_float(0x3c000000u | (static_cast<uint32_t>(db) & 0xffu)) * i;\n"
             "    }\n"),
            ("    wgmma_rs_mn<HDP>(acc, a, db);\n",
             "    acc[kk] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);\n")]),
    }
    v["softmax_only_no_exp"] = _edit(v["softmax_only"], [(exp, no_exp)])
    return v


def bwd_variants(src: str) -> dict:
    """The float32 backward's variants (text edits of ``src``), "kernel"
    first."""
    loop = "#pragma unroll 1\n  for (int ch = 0; ch < kChunks; ++ch) {"
    return {"kernel": src,
            "bwd_chunks_unrolled": _edit(src, [(loop, loop.replace(" 1\n", "\n"))]),
            "bwd_chunks_by2": _edit(src, [(loop, loop.replace(" 1\n", " 2\n"))])}


def build_all(todo: dict, include: dict) -> dict:
    """{name: (library path, nvcc's log)} of each source text in ``todo``,
    all compiled at once with the build's flags into OUT, each against the
    csrc directory ``include[name]`` (this checkout's by default)."""
    from repro_torch.device import nvcc_path
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in todo.items():
        cu, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *build.NVCC_FLAGS, "-I", str(include.get(name, build.CSRC)), "-o", lib,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate(timeout=build.NVCC_TIMEOUT_S)[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        out[name] = (lib, log)
    return out


def parent_bwd_tiles(parent: str) -> tuple:
    """The float32 backward's tile constants of the checkout at ``parent``,
    read from its kernels/autotune.py without importing it: the FFMA
    grid's three (block_q, block_k, threads) or the TMA ring's five."""
    path = os.path.join(parent, "src", "repro_torch", "kernels", "autotune.py")
    consts = {t.id: node.value.value for node in ast.parse(open(path).read()).body
              if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
              for t in node.targets if isinstance(t, ast.Name)}
    names = (("FLASH_BWD_BLOCK_Q", "FLASH_BWD_BLOCK_K", "FLASH_BWD_THREADS")
             if "FLASH_BWD_BLOCK_Q" in consts else
             ("FLASH_BWD_BLOCK_ROWS", "FLASH_BWD_TILE_ROWS", "FLASH_BWD_STAGES",
              "FLASH_BWD_MICRO_ROWS", "FLASH_BWD_MICRO_COLS"))
    return tuple(consts[n] for n in names)


def bwd_call(fn, tiles: tuple):
    """A function of (q, k, v, o, lse, do, window, softcap) that launches
    the float32 backward C entry ``fn`` with ``tiles`` as the wrapper
    (kernels/flash_attention.py:flash_attention_bwd) does."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fa
    fn.argtypes, fn.restype = list(fa._bwd_argtypes(len(tiles))), ctypes.c_int

    def run(q, k, v, o, lse, do, window, softcap):
        B, S, H, hd = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rows = autotune.FLASH_BWD_TC_BLOCK_ROWS
        stat_s = -(-S // rows) * rows
        lse2, dsum = torch.empty((2, B * H, stat_s), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 24)(*(st for t in (q, k, v, o, do, dq, dk, dv)
                                             for st in fa.tma_strides(t.shape, t.stride())))
        rc = fn(*(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv, lse2, dsum)),
                B, S, H, k.shape[2], hd, *tiles, stat_s, strides, window, hd ** -0.5,
                0.0 if softcap is None else float(softcap),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the backward's launch failed with error {rc}")
        return dq, dk, dv
    return run


def kernel_split(fn) -> dict:
    """Device time in ms of each flash_bwd kernel of one call of ``fn``,
    from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        hit = re.search(r"flash_bwd_\w+?_kernel", ev.key)
        if hit:
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            out[hit.group(0)] = out.get(hit.group(0), 0.0) + us / 1e3
    return out


def bwd_main(args) -> int:
    """The backward mode (module docstring)."""
    import torch

    import chip_smoke
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    todo = bwd_variants(open(BWD_SOURCE).read())
    tiles = {n: fa._BWD_ENTRIES[torch.float32][1] for n in todo}
    include = {}
    if args.parent:
        todo["parent"] = open(os.path.join(args.parent, os.path.relpath(BWD_SOURCE, ROOT))).read()
        tiles["parent"] = parent_bwd_tiles(args.parent)
        include["parent"] = os.path.dirname(os.path.join(args.parent,
                                                         os.path.relpath(BWD_SOURCE, ROOT)))
    if args.only:
        keep = {"kernel", *args.only.split(",")}
        todo = {n: t for n, t in todo.items() if n in keep}
    built = build_all(todo, include)
    regs, fns = {}, {}
    for name, (lib, log) in built.items():
        every = chip_smoke.flash_bwd_kernels(chip_smoke.ptxas_by_kernel(log),
                                             chip_smoke.sass_ops_by_kernel(lib))
        regs[name] = {k: [e["registers"], e["spill_store_bytes"]] for k, e in every.items()
                      if "wgmma" not in k and "dsum" not in k}
        fns[name] = bwd_call(ctypes.CDLL(lib).repro_flash_attention_bwd, tiles[name])

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.LM_SEED)
    times, splits, same, over_bar = {}, {}, {}, {}
    for label, (shape, window, cap) in chip_smoke.BWD_PATH_SHAPES.items():
        B, S, H, G, hd = shape
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev)
                       for sh in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd), (B, S, H, hd)))
        for c in ((cap, None) if cap is not None else (None,)):
            case = label if c == cap else f"{label}_no_softcap"
            o, lse = fa.flash_attention(q, k, v, window=window, softcap=c, return_lse=True)
            call = lambda f: f(q, k, v, o, lse, do, window, c)
            base = call(fns["kernel"])
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window, softcap=c)
            outs = {name: call(f) for name, f in fns.items()}
            same[case] = {n: all(torch.equal(a, b) for a, b in zip(got, base))
                          for n, got in outs.items()}
            over_bar[case] = {n: max(float((a - w).abs().max())
                                     / (chip_smoke.BWD_F32_RTOL_OF_MAX * float(w.abs().max()))
                                     for a, w in zip(got, want)) for n, got in outs.items()}
            del base, want, outs
            times[case] = {n: [] for n in fns}
            for name in list(fns) + list(fns)[::-1]:
                times[case][name].append(chip_smoke.device_ms(lambda: call(fns[name]),
                                                              BWD_REPS))
            splits[case] = {n: kernel_split(lambda: call(f)) for n, f in fns.items()}
            del o, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    print(gpu_name_and_power_limit())
    print(json.dumps({"mode": "bwd", "shapes": {l: list(s) for l, s in
                                                 chip_smoke.BWD_PATH_SHAPES.items()},
                      "times_ms": times,
                      "median_ms": {c: {n: statistics.median(m) for n, m in t.items()}
                                    for c, t in times.items()},
                      "kernels_ms": splits, "bitwise_equal_to_kernel": same,
                      "err_over_bar": over_bar, "registers_spill_bytes": regs,
                      "timing": f"median of {BWD_REPS} calls between CUDA events, in turns"}))
    bad = [(c, n) for c, e in over_bar.items() for n, x in e.items() if not x <= 1.0]
    return 1 if bad else 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose kernel is built as the variant 'parent'")
    ap.add_argument("--only", help="comma-separated variants to build and time besides "
                                   "'kernel' (default: every one)")
    ap.add_argument("--bwd", action="store_true", help="the float32 backward kernels instead "
                                                       "of the forward's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    if args.bwd:
        return bwd_main(args)
    import chip_smoke
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import flash_attention as fa

    src = open(SOURCE).read()
    todo = bf16_variants(src)
    f32_names = ["kernel", *f32_variants(src)]
    todo.update(f32_variants(src))
    include = {}
    if args.parent:
        todo["parent"] = open(os.path.join(args.parent, os.path.relpath(SOURCE, ROOT))).read()
        include["parent"] = os.path.dirname(os.path.join(args.parent, os.path.relpath(SOURCE, ROOT)))
        f32_names.append("parent")
    if args.only:
        keep = {"kernel", *args.only.split(",")}
        todo = {n: t for n, t in todo.items() if n in keep}
        f32_names = [n for n in f32_names if n in keep]
    bf16_names = [n for n in todo if n == "parent" or n not in f32_names[1:]]
    fns, ptxas = {torch.bfloat16: {}, torch.float32: {}}, {}
    for name, (lib, log) in build_all(todo, include).items():
        ptxas[name] = (chip_smoke.flash_kernel_ptxas(log, "wgmma_kernelILi128ELb1")
                       + chip_smoke.flash_kernel_ptxas(log, "f32_kernelILi128E"))
        for dtype, names in ((torch.bfloat16, bf16_names), (torch.float32, f32_names)):
            if name in names:
                symbol, tiles = fa._ENTRIES[dtype]
                fn = getattr(ctypes.CDLL(lib), symbol)
                fn.argtypes, fn.restype = list(fa._argtypes(len(tiles))), ctypes.c_int
                fns[dtype][name] = fn

    current = {}
    real_entry = fa._launch.c_entry
    fa._launch.c_entry = lambda src_, sym, argtypes: current["fn"]
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(chip_smoke.LM_SEED)

        def qkv(B, S, H, G, hd, dtype):
            return [torch.randn(sh, generator=gen, device=dev).to(dtype)
                    for sh in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd))]

        def error(q, k, v, w, cap):
            """The worst error of the current library at a small shape
            against its bar: bf16 over chip_smoke's elementwise bar, float32
            over FLASH_F32_ATOL."""
            got = fa.flash_attention(q, k, v, window=w, softcap=cap)
            want = ref.flash_attention_ref(q, k, v, window=w, softcap=cap)
            if q.dtype == torch.float32:
                return float((got - want).abs().max()) / chip_smoke.FLASH_F32_ATOL
            return chip_smoke.flash_bf16_errors(
                got, want, ref.flash_attention_ref(q, k, v.abs(), window=w, softcap=cap),
            )["max_err_over_bar"]

        small = [((1, 300, 4, 2, 128), None, 50.0), ((2, 129, 16, 2, 128), 16, 50.0),
                 ((1, 200, 4, 2, 80), 64, None), ((1, 513, 4, 4, 64), 100, 50.0)]
        cases = {"global": (0, 50.0), "window4096": (4096, 50.0), "no_softcap": (0, None)}
        worst, same, times = {}, {}, {}
        for dtype, lib_fns in fns.items():
            label = str(dtype).split(".")[-1]
            small_inputs = [(qkv(*sh, dtype), w, cap) for sh, w, cap in small]
            worst[label] = {}
            for name, fn in lib_fns.items():
                current["fn"] = fn
                worst[label][name] = max(error(q, k, v, w, cap)
                                         for (q, k, v), w, cap in small_inputs)
            del small_inputs
            q, k, v = qkv(1, chip_smoke.LM_SEQ, 32, 16, 128, dtype)
            current["fn"] = lib_fns["kernel"]
            base = {c: fa.flash_attention(q, k, v, window=w, softcap=cap)
                    for c, (w, cap) in cases.items()}
            same[label] = {}
            for name, fn in lib_fns.items():
                current["fn"] = fn
                same[label][name] = all(
                    torch.equal(fa.flash_attention(q, k, v, window=w, softcap=cap), base[c])
                    for c, (w, cap) in cases.items())
            del base
            times[label] = {name: {c: [] for c in cases} for name in lib_fns}
            for name in list(lib_fns) + list(lib_fns)[::-1]:
                current["fn"] = lib_fns[name]
                for c, (w, cap) in cases.items():
                    times[label][name][c].append(autotune.device_time_ms(
                        lambda: fa.flash_attention(q, k, v, window=w, softcap=cap), REPS))
            del q, k, v
            torch.cuda.empty_cache()
    finally:
        fa._launch.c_entry = real_entry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(gpu_name_and_power_limit())
    print(json.dumps({"shape": [1, chip_smoke.LM_SEQ, 32, 16, 128], "times_ms": times,
                      "small_worst_over_bar": worst, "bitwise_equal_to_kernel": same,
                      "ptxas_hd128": ptxas, "nvidia_smi": smi,
                      "timing": f"median of {REPS} calls between CUDA events, in turns"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
