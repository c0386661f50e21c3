#!/usr/bin/env python3
"""What each piece of the bf16 flash kernel buys, on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/flash_ablation.py

Builds src/repro_torch/kernels/csrc/flash_attention.cu as it is
("kernel") and variants made from it by text edits, each with nvcc into
its own library (all at once), and times the bf16 kernel of each at
gemma2-27b's prefill shape (1, 8192, 32, 16, 128): softcap 50 global and
with window 4096, and no softcap, in turns (every variant, then again in
reverse order; each time the median of 20 calls between CUDA events).

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

Every variant is checked against the plain version at small shapes (the
bar of chip_smoke.py) and, at the path shape, bit for bit against
"kernel": all but the four diagnostics (gemm_only, softmax_only,
softmax_only_no_exp, no_loads) and one_chain (which sums l in another
order) keep the arithmetic. Prints one JSON line, and the card's name,
power limit and SM clock. Needs no network.

The variants are text edits of the kernel's source: an edit that no longer
applies after a change to the kernel raises ValueError naming it, and the
variant has to be written anew against the new source.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "flash_ablation")
REPS = 20


def _edit(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise ValueError(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants(src: str) -> dict:
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
            ("    wgmma_ss_n128(s, da, db, kk > 0);\n",
             "    if (kk == 0) {\n"
             "      for (int i = 0; i < kBlockK / 2; ++i)\n"
             "        s[i] = __uint_as_float(0x3c000000u | (static_cast<uint32_t>(db) & 0xffu)) * i;\n"
             "    }\n"),
            ("      wgmma_rs_n128(acc, a, db);\n",
             "      acc[kk] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);\n"),
            ("      wgmma_rs_n64(acc, a, db);\n",
             "      acc[kk] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);\n")]),
    }
    v["softmax_only_no_exp"] = _edit(v["softmax_only"], [(exp, no_exp)])
    return v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.device import gpu_name_and_power_limit, nvcc_path
    from repro_torch.kernels import autotune, build, ref
    from repro_torch.kernels import flash_attention as fa

    src = open(SOURCE).read()
    todo = variants(src)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in todo.items():
        cu, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([nvcc_path(), *build.NVCC_FLAGS, "-o", lib, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    fns, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate(timeout=build.NVCC_TIMEOUT_S)[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        ptxas[name] = chip_smoke.flash_kernel_ptxas(log, "wgmma_kernelILi128ELb1")
        fn = ctypes.CDLL(lib).repro_flash_attention_bf16
        fn.argtypes, fn.restype = list(fa._ARGTYPES), ctypes.c_int
        fns[name] = fn

    current = {}
    real_entry = fa._launch.c_entry
    fa._launch.c_entry = lambda src_, sym, argtypes: current["fn"]
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(chip_smoke.LM_SEED)

        def qkv(B, S, H, G, hd):
            return [torch.randn(sh, generator=gen, device=dev).bfloat16()
                    for sh in ((B, S, H, hd), (B, S, G, hd), (B, S, G, hd))]

        small = [((1, 300, 4, 2, 128), None, 50.0), ((2, 129, 16, 2, 128), 16, 50.0),
                 ((1, 200, 4, 2, 80), 64, None), ((1, 513, 4, 4, 64), 100, 50.0)]
        small_inputs = [(qkv(*sh), w, cap) for sh, w, cap in small]
        worst = {}
        for name, fn in fns.items():
            current["fn"] = fn
            worst[name] = max(
                chip_smoke.flash_bf16_errors(
                    fa.flash_attention(q, k, v, window=w, softcap=cap),
                    ref.flash_attention_ref(q, k, v, window=w, softcap=cap),
                    ref.flash_attention_ref(q, k, v.abs(), window=w, softcap=cap),
                )["max_err_over_bar"] for (q, k, v), w, cap in small_inputs)
        q, k, v = qkv(1, chip_smoke.LM_SEQ, 32, 16, 128)
        cases = {"global": (0, 50.0), "window4096": (4096, 50.0), "no_softcap": (0, None)}
        current["fn"] = fns["kernel"]
        base = {c: fa.flash_attention(q, k, v, window=w, softcap=cap)
                for c, (w, cap) in cases.items()}
        same = {}
        for name, fn in fns.items():
            current["fn"] = fn
            same[name] = all(torch.equal(fa.flash_attention(q, k, v, window=w, softcap=cap),
                                         base[c]) for c, (w, cap) in cases.items())
        times = {name: {c: [] for c in cases} for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            current["fn"] = fns[name]
            for c, (w, cap) in cases.items():
                times[name][c].append(autotune.device_time_ms(
                    lambda: fa.flash_attention(q, k, v, window=w, softcap=cap), REPS))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = autotune.device_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), REPS)
    finally:
        fa._launch.c_entry = real_entry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(gpu_name_and_power_limit())
    print(json.dumps({"shape": [1, chip_smoke.LM_SEQ, 32, 16, 128], "times_ms": times,
                      "sdpa_no_softcap_ms": sdpa, "small_worst_over_bar": worst,
                      "bitwise_equal_to_kernel": same, "ptxas_hd128_softcap": ptxas,
                      "nvidia_smi": smi,
                      "timing": f"median of {REPS} calls between CUDA events, in turns"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
