"""Readings for the limits of ``correct``: the program's numbers compared,
and the control's (the reference computed in bfloat16 in the program's
place), over many seeds in one process, at the cell's own size and load.

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

One JSON line a seed on standard output, with the control judged as the
program is (``harness.judge``: it has to come out not correct); the
benchmark's runs never run this. Each limit in ``workloads/<cell>.json``
lies between the largest program reading and the smallest control reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(ROOT / "chipbench" / ".autotune")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                               control=args.control)
        info = out["info"]
        print(json.dumps({
            "seed": seed, "correct": out["result"]["correct"],
            "numbers": {k: c["value"] for k, c in out["result"]["checks"].items()},
            "control": info.get("control"), "slots": info["slots"],
            "metrics": out["result"]["metrics"], "check_s": info["check_s"],
            "diag": {k: v for k, v in info.items() if k not in ("control",)},
            "seconds": time.perf_counter() - t0}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
