"""Kernel tiling-constant locality rule (counterpart of
``repro.analysis.lint.rules_tiling``, its names half).

Every launch constant of the port's CUDA kernels (threads per row, rows
per block, ``MAX_L``, the bisect iteration counts, the flash kernels' tile
sizes) lives in ``kernels/autotune.py``, the module the shape-aware
autotuner enumerates, measures and caches winners from. A tile constant
spelled out anywhere else silently forks the config space: the tuner
keeps tuning the real knob while the stray literal pins some call site to
a stale shape.

The rule rejects, everywhere except ``kernels/autotune.py``, module- and
class-level assignments of integer literals (or tuples of them) to
tiling-named constants — ``ROW_BLOCK*``, ``*BLOCK*``, ``*TILE*``,
``*LANE*``/``*SUBLANE*``, bare ``ITERS`` or ``*BISECT_ITERS`` (name a
non-tiling iteration count specifically, e.g. ``MULTICLASS_ITERS``, and
it passes).

The reference's other half, integer literals in a ``pl.BlockSpec`` block
shape, has no object in the port: no Python code spells a block shape.
The tile constants of ``kernels/csrc/`` are C++ constants, and each C
entry refuses at launch a tile that differs from the one the Python
wrapper passes from ``autotune`` (``csrc/flash_attention.cu``'s entries
against ``autotune.FLASH_TC_*`` and ``FLASH_*``, passed by
``kernels/flash_attention.py``), so a fork between the two fails on the
first call; no rule reads ``csrc/``.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.analysis.lint.core import Finding, FileContext, Rule, register

# the one module allowed to spell out tile integers
TILING_HOME = "kernels/autotune.py"

_TILING_NAME = re.compile(
    r"^_?("
    r"[A-Z0-9_]*BLOCK[A-Z0-9_]*"      # ROW_BLOCK, BLOCK_Q, FLASH_BLOCK_K...
    r"|[A-Z0-9_]*TILE[A-Z0-9_]*"      # TILE_M, KV_TILES...
    r"|[A-Z0-9_]*SUBLANE[A-Z0-9_]*"   # SUBLANE_FLOOR...
    r"|[A-Z0-9_]*LANES?(_[A-Z0-9_]+)?"  # LANE_FLOOR, SCAL_LANES...
    r"|ITERS|[A-Z0-9_]*BISECT_ITERS"  # the kernel knob; MULTICLASS_ITERS passes
    r")$"
)


def _int_literal_value(node: ast.expr):
    """The int (or tuple-of-int) literal value of ``node``, else None."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
        isinstance(e, ast.Constant) and type(e.value) is int
        for e in node.elts
    ):
        return tuple(e.value for e in node.elts)
    return None


@register
class HardcodedTiling(Rule):
    name = "hardcoded-tiling"
    summary = (
        "tile shape spelled as an integer literal outside kernels/autotune.py"
        " — forks the autotuner's config space; reference the autotune "
        "constant"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        if ctx.path.replace("\\", "/").endswith(TILING_HOME):
            return
        # module- and class-level bindings only
        scopes = [module.body] + [
            n.body for n in module.body if isinstance(n, ast.ClassDef)
        ]
        for body in scopes:
            for stmt in body:
                if isinstance(stmt, ast.Assign):
                    targets, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    targets, value = [stmt.target], stmt.value
                else:
                    continue
                if _int_literal_value(value) is None:
                    continue
                for t in targets:
                    if isinstance(t, ast.Name) and _TILING_NAME.match(t.id):
                        yield self.finding(
                            ctx, stmt,
                            f"tiling constant '{t.id} = {ast.unparse(value)}' "
                            "hardcoded outside kernels/autotune.py — the "
                            "autotuner tunes a different knob than this call "
                            "site runs; move the literal into autotune.py "
                            "and reference it",
                        )
