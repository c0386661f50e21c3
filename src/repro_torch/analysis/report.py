"""The roofline markdown table of the dry run's records (counterpart of
``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report [--art artifacts/dryrun] \\
        [--out artifacts/roofline_table.md]

The roofline fraction is MODEL_FLOPS over what the positions could do at
the H100's dense bf16 tensor-core peak in the dominant term's time.
"""
from __future__ import annotations

import argparse
import glob
import json

from repro_torch.analysis.roofline import PEAK_FLOPS, dryrun_summary

IMPROVE = {
    ("compute", "train"): "cut remat recompute (dots policy) / raise per-chip batch",
    ("compute", "prefill"): "flash-attention kernel tiling (q-block skip on windows)",
    ("compute", "decode"): "batch more sequences per step",
    ("memory", "decode"): "KV-cache quantisation (int8) halves cache streaming",
    ("memory", "train"): "chunked CE + SP carry already applied; microbatch next",
    ("memory", "prefill"): "emit cache in bf16 blocks, fuse norm+matmul",
    ("memory", "sched"): "fused OGA kernel (1 HBM pass, measured 1.51x)",
    ("collective", "train"): "pure-DP plan for small archs; head-parallel attention; overlap FSDP gathers",
    ("collective", "prefill"): "head-parallel attention (one seq AG per layer)",
    ("collective", "decode"): "shard KV heads not seq; batch over both axes",
}


def load(art_dir: str, mesh: str) -> list:
    rows = []
    for p in sorted(glob.glob(f"{art_dir}/*__{mesh}.json")):
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def table(rows, n_chips: int) -> str:
    out = [
        "| arch / shape | dominant | t_compute s | t_memory s | t_collective s "
        "| roofline frac | useful flops | temp GB/dev | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        s = dryrun_summary(r)
        tag = s["tag"]
        if s["status"] == "skipped":
            out.append(f"| {tag} | — | — | — | — | — | — | — | SKIP: {s['reason'][:70]} |")
            continue
        if s["status"] != "ok":
            out.append(f"| {tag} | ERROR | | | | | | | |")
            continue
        t_dom = s["t_dominant_s"]
        frac = s["model_flops"] / (n_chips * PEAK_FLOPS * t_dom) if t_dom > 0 else 0.0
        note = IMPROVE.get((s["dominant"], s["kind"]), "")
        out.append(
            f"| {tag} | {s['dominant']} | {s['t_compute_s']:.4f} | "
            f"{s['t_memory_s']:.4f} | {s['t_collective_s']:.4f} | "
            f"{frac:.3f} | {s['useful_flops']:.2f} | "
            f"{s['temp_gb']:.1f} | {note} |"
        )
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun")
    ap.add_argument("--out", default="artifacts/roofline_table.md")
    args = ap.parse_args(argv)
    doc = ["# Roofline table (from the dry run's records, NVIDIA H100 peaks)\n"]
    for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
        rows = [r for r in load(args.art, mesh) if "variant" not in r]
        doc.append(f"\n## mesh {mesh} ({chips} positions)\n")
        doc.append(table(rows, chips))
    variants = []
    for p in sorted(glob.glob(f"{args.art}/*__*__*__*.json")):
        with open(p) as f:
            variants.append(json.load(f))
    variants = [v for v in variants if v.get("variant")]
    if variants:
        doc.append("\n## hillclimb variants (single-pod)\n")
        doc.append(table(variants, 256))
    text = "\n".join(doc)
    with open(args.out, "w") as f:
        f.write(text)
    print(text[:2000])
    print(f"... written to {args.out}")
    return text


if __name__ == "__main__":
    main()
