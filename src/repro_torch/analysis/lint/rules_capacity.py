"""Residual-capacity feasibility rule (counterpart of
``repro.analysis.lint.rules_capacity``).

The fault-injected lifecycle executes against a *surviving* capacity
``c_t = c * fault_multiplier`` that can collapse below what running jobs
already hold, so the residual ``c - used`` is no longer non-negative by
construction. An unguarded subtraction ships a negative "capacity"
downstream — the water-filling and projection kernels divide by it, and a
negative residual turns into NaN allocations three calls away from the
bug (the reason ``graph.residual_capacity`` floors at zero).

The rule rejects a subtraction FROM a capacity-named operand (``c``,
``cap``/``capacity`` variants, ``c_*`` like ``c_t`` / ``c_res``, or an
attribute such as ``spec.c``) that is not wrapped in a clip/floor guard and
is not part of a comparison (a feasibility *check* like ``c - used >= -tol``
reads the sign; it does not ship the residual). The guards are the
reference's (``jnp`` and numpy ``maximum`` / ``clip`` / ``where``,
``jax.nn.relu``), so the JAX package's tests lint clean here too, plus
torch's: ``torch.maximum``, ``torch.clamp``, ``torch.clamp_min``,
``torch.clip``, ``torch.where``, ``torch.relu``, ``F.relu``, and the
method forms ``(c - used).clamp(...)`` / ``.clamp_min`` / ``.clip`` /
``.relu``.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.lint import astutil
from repro_torch.analysis.lint.core import Finding, FileContext, Rule, register

# calls that bound the residual below (or select away the negative branch)
GUARDS = {
    "jax.numpy.maximum",
    "jax.numpy.clip",
    "jax.numpy.where",
    "numpy.maximum",
    "numpy.clip",
    "numpy.where",
    "jax.nn.relu",
    "torch.maximum",
    "torch.clamp",
    "torch.clamp_min",
    "torch.clip",
    "torch.where",
    "torch.relu",
    "torch.nn.functional.relu",
}
# tensor methods that floor their receiver
GUARD_METHODS = {"clamp", "clamp_min", "clip", "relu"}

_CAP_EXACT = {"c", "cap", "caps", "capacity", "capacities"}
_CAP_SUFFIX = ("_cap", "_caps", "_capacity")


def _capacity_name(node: ast.expr) -> Optional[str]:
    """Terminal identifier of a capacity-like operand, else None: peels
    subscripts (``c[None]``) and reads the attribute name (``spec.c``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    low = name.lower()
    if low in _CAP_EXACT or low.startswith("c_") or low.endswith(_CAP_SUFFIX):
        return name
    return None


def _has_variable(node: ast.expr) -> bool:
    return any(
        isinstance(n, (ast.Name, ast.Attribute)) for n in ast.walk(node)
    )


def _is_guard(imports: astutil.Imports, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if imports.resolve(node.func) in GUARDS:
        return True
    f = node.func
    return isinstance(f, ast.Attribute) and f.attr in GUARD_METHODS


@register
class UnvalidatedCapacityMask(Rule):
    name = "unvalidated-capacity-mask"
    summary = (
        "capacity minus usage without a clip/feasibility guard — residuals "
        "go negative under capacity faults; wrap in torch.clamp_min(..., "
        "0.0) or torch.clamp"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        covered: set[int] = set()
        for node in astutil.all_nodes(module):
            # comparisons/asserts READ the residual's sign (feasibility
            # checks); only a residual that flows onward needs the floor
            if _is_guard(imports, node) or isinstance(
                node, (ast.Compare, ast.Assert)
            ):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.BinOp) and isinstance(
                        sub.op, ast.Sub
                    ):
                        covered.add(id(sub))
        for node in astutil.all_nodes(module):
            if not (
                isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Sub)
                and id(node) not in covered
            ):
                continue
            cap = _capacity_name(node.left)
            if cap is None or not _has_variable(node.right):
                continue
            yield self.finding(
                ctx, node,
                f"'{ast.unparse(node)}' subtracts usage from capacity "
                f"'{cap}' with no clip/feasibility guard; under capacity "
                "faults the residual goes negative and poisons downstream "
                "water-filling/projection — wrap in torch.clamp_min(..., "
                "0.0) or torch.clamp, or guard with torch.where",
            )
