"""Command-line entry point (counterpart of ``repro.analysis.lint.cli``).

    PYTHONPATH=src python -m repro_torch.analysis.lint [paths ...]

The default paths are the port, the tests and ``chip_smoke.py``, relative
to the working directory (run it from the repository's root). Exit status:
0 clean, 1 findings, 2 usage error. ``--json-out`` writes the
machine-readable report whatever the display format.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.analysis.lint.core import RULES, lint_paths
from repro_torch.analysis.lint.reporters import render_json, render_text

DEFAULT_PATHS = ("src/repro_torch", "tests", "chip_smoke.py")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch-aware static analysis for this repo's bug taxonomy",
    )
    ap.add_argument(
        "paths", nargs="*", default=list(DEFAULT_PATHS),
        help=f"files or directory trees (default: {' '.join(DEFAULT_PATHS)})",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="stdout format (default text)",
    )
    ap.add_argument(
        "--json-out", metavar="FILE", default=None,
        help="also write the JSON report to FILE",
    )
    ap.add_argument(
        "--rule", action="append", metavar="NAME", default=None,
        help="run only these rules (repeatable)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(n) for n in RULES)
        for name, cls in sorted(RULES.items()):
            print(f"{name:<{width}}  {cls.summary}")
        return 0

    try:
        findings = lint_paths(args.paths, rules=args.rule)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    except OSError as e:
        print(f"cannot lint: {e}", file=sys.stderr)
        return 2

    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(render_json(findings, args.paths) + "\n")
    if args.format == "json":
        print(render_json(findings, args.paths))
    else:
        print(render_text(findings))
    return 1 if findings else 0
