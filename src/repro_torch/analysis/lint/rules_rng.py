"""RNG stream-derivation rule (counterpart of
``repro.analysis.lint.rules_rng``).

The reference's trace once seeded its spec/arrivals/works streams as
``seed``, ``seed + 1``, ``seed + 2``, so sweep seed ``s``'s arrival stream
was bit-identical to seed ``s+1``'s spec stream: adjacent grid configs
shared randomness. Streams are derived with
``np.random.SeedSequence(seed).spawn`` instead. This rule rejects the
arithmetic scheme at the source: any ``seed ± k`` / ``seed * k``
expression feeding an RNG constructor or seeder.

The port seeds torch's generators too (``torch.Generator(device).
manual_seed(seed)`` in ``serve/engine.py`` and ``models/model.py``), so the
seeders are the reference's numpy and ``random`` constructors plus
``torch.manual_seed``, ``torch.cuda.manual_seed``,
``torch.cuda.manual_seed_all`` and any ``<obj>.manual_seed(...)``. The
reference's ``jax.random`` constructors have no object in the port.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.lint import astutil
from repro_torch.analysis.lint.core import Finding, FileContext, Rule, register

# RNG entry points whose seed argument defines an independent stream
RNG_CONSTRUCTORS = {
    "numpy.random.default_rng",
    "numpy.random.seed",
    "numpy.random.RandomState",
    "numpy.random.SeedSequence",
    "random.seed",
    "random.Random",
}
# torch's seeders, called on the module or on a Generator
SEEDERS = {"manual_seed", "manual_seed_all"}

_ARITH = (ast.Add, ast.Sub, ast.Mult)


def _offset_arith(node: ast.expr) -> bool:
    """True for +/-/* expressions mixing a variable with anything — the
    ``seed + k`` shape. Pure-constant arithmetic is collision-free."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, _ARITH)):
        return False
    has_var = any(
        isinstance(n, (ast.Name, ast.Attribute, ast.Subscript))
        for n in ast.walk(node)
    )
    return has_var


def _seeder(imports: astutil.Imports, call: ast.Call) -> Optional[str]:
    """The seeder's canonical name, or None when ``call`` seeds nothing."""
    cn = imports.resolve(call.func)
    if cn in RNG_CONSTRUCTORS:
        return cn
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in SEEDERS:
        return cn or f.attr
    if cn and cn.startswith("torch.") and cn.rsplit(".", 1)[-1] in SEEDERS:
        return cn
    return None


@register
class RngOffsetDerivation(Rule):
    name = "rng-offset-derivation"
    summary = (
        "seed arithmetic (seed+k / seed*k) feeding an RNG constructor or "
        "manual_seed — derive streams with SeedSequence.spawn"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        for node in astutil.all_nodes(module):
            if not isinstance(node, ast.Call):
                continue
            cn = _seeder(imports, node)
            if cn is None:
                continue
            exprs = list(node.args) + [
                kw.value for kw in node.keywords if kw.arg in (None, "seed")
            ]
            for arg in exprs:
                if _offset_arith(arg):
                    yield self.finding(
                        ctx, arg,
                        f"'{ast.unparse(arg)}' derives an RNG stream by seed "
                        f"arithmetic into {cn.rsplit('.', 1)[-1]}; offset "
                        "seeds collide across runs (the sweep-stream "
                        "collision) — use np.random.SeedSequence(seed)"
                        ".spawn(n) or a tuple seed, and seed torch from a "
                        "spawned child's generate_state",
                    )
