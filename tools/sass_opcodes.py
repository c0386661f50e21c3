#!/usr/bin/env python3
"""Opcode counts of the port's built CUDA kernels, on a machine with nvcc.

Run from the root of a checkout:

    python3 tools/sass_opcodes.py [--source oga_step.cu] [--match sortscan]

Builds src/repro_torch/kernels/csrc (kernels.build) and prints one JSON
line per kernel of the library built from SOURCE whose mangled name holds
MATCH: its instruction count by base opcode and in total, from
``cuobjdump -sass`` (chip_smoke.py's ``sass_ops_by_kernel``). A kernel
that is fully unrolled issues about its total once per warp, so the total
is the first thing to read when such a kernel is bound by instruction
issue. Needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="oga_step.cu")
    ap.add_argument("--match", default="sortscan")
    args = ap.parse_args()
    import chip_smoke
    from repro_torch.kernels import build

    build.build()
    counts = chip_smoke.sass_ops_by_kernel(str(build.library_path(args.source)))
    for name, ops in counts.items():
        if args.match in name:
            print(json.dumps({"kernel": name, "total": ops["total"],
                              "ops": dict(ops.most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
