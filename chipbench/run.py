"""Run one cell of the benchmark once, on the card this process finds.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints progress and the numbers compared
on standard error (the numbers last), and one JSON object as the last line
of standard output: correct, attempted, failed, metrics, device (with
--trace 1 also busy_s, window_s and the breakdown), checks. Exits with
another code than 0, and prints no result, without a CUDA card, with fewer
cards than the cell asks for, without the program beside the benchmark, or
when the process has loaded JAX or the JAX package by the window's close.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout, so only the
# first run of a checkout builds and tunes
CACHES = {"REPRO_TORCH_AUTOTUNE_CACHE": ROOT / "chipbench" / ".autotune",
          "TRITON_CACHE_DIR": ROOT / "chipbench" / ".triton"}
# top-level modules that may not be loaded: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

EXIT_NO_CARD = 3
EXIT_NO_PROGRAM = 4
EXIT_FORBIDDEN = 5


def forbidden_modules(modules=None) -> list[str]:
    """Names among ``modules`` (``sys.modules`` by default) whose top-level
    name (before the first dot) is one of FORBIDDEN, compared whole:
    ``repro_torch`` is not ``repro``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def card_readings() -> str:
    """nvidia-smi's name, power limit, clocks, power and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.mem,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "chipbench"]

    import torch

    from chipbench import harness

    t_torch = time.perf_counter() - T_START

    chips = harness.cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: the cell needs {chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chipbench: the program (src/repro_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return EXIT_NO_PROGRAM

    print(f"chipbench: {args.workload} seed {args.seed} {args.seconds} s trace {args.trace}; "
          f"card: {card_readings()}", file=sys.stderr)
    t0 = time.perf_counter()
    torch.empty(1, device="cuda")
    pre = {"torch_import_s": t_torch, "cuda_context_s": time.perf_counter() - t0}
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, info=pre)
    found = forbidden_modules()
    if found:
        print(f"chipbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    info = out["info"]
    print(f"chipbench: card after the window: {card_readings()}", file=sys.stderr)
    print("chipbench: info " + json.dumps(info, default=str), file=sys.stderr)
    for row in out["rows"]:
        print("chipbench: checked " + json.dumps(row), file=sys.stderr)
    result = out["result"]
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
