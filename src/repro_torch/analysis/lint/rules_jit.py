"""The torch hot-context rules (counterpart of
``repro.analysis.lint.rules_jit``, whose jit and ``lax`` loop bodies have
no object in eager torch).

Both rules read :func:`astutil.hot_contexts`: the per-slot loops (a
``for ... in range(...)`` or ``while`` loop whose own body stores into a
subscript, calls an in-place tensor method or calls through ``ops.``) and
the code captured into a CUDA graph.

* `host-sync-in-hot-loop` — a read of a tensor on the host inside a hot
  context makes the host wait for the card every step, so the launches of
  the next step cannot queue behind the running ones; inside a graph
  capture it raises. The syncs: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.nonzero()``, ``torch.cuda.synchronize``,
  ``torch.nonzero``, ``torch.unique``, ``torch.masked_select``,
  ``F.one_hot`` without ``num_classes`` (it reads its indices' maximum),
  and ``float()`` / ``int()`` / ``bool()`` of a parameter, as in the
  reference. A value that is visibly numpy (a ``numpy.*`` call, a
  ``.numpy()``, a name bound to one) is host memory already and is not
  flagged: the port's float64 oracles loop over numpy rows.
* `impure-graph-capture` — replaces the reference's `impure-scan-body`.
  A graph runs its Python once, at capture, and replays only the kernels:
  ``global`` / ``nonlocal`` rebinding, attribute writes, mutation of a
  closed-over container (``append``, ``update``, ...) and ``print`` inside
  a capture happen once and never at replay. In-place tensor operations
  (``x.add_(...)``, ``out[...] = y``, ``static.copy_(...)``) are recorded
  as kernels and are the sanctioned forms.

The reference's `sort-in-loop` and `nonhashable-jit-static` have no torch
object (``NO_TORCH_OBJECT`` in the package says why).
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.lint import astutil
from repro_torch.analysis.lint.core import Finding, FileContext, Rule, register

# tensor methods that read the tensor's values on the host
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
# torch calls that wait for the card or size their output from its values
SYNC_CALLS = {
    "torch.cuda.synchronize",
    "torch.nonzero",
    "torch.unique",
    "torch.masked_select",
}
ONE_HOT = "torch.nn.functional.one_hot"

PY_SCALAR_CASTS = {"float", "int", "bool", "complex"}

# container methods that mutate their receiver (a tensor's ``add`` is out
# of place, so it is not among them)
MUTATING_CONTAINER_METHODS = {
    "append", "extend", "insert", "update", "pop", "popitem",
    "setdefault", "remove", "discard", "clear",
}


@register
class HostSyncInHotLoop(Rule):
    name = "host-sync-in-hot-loop"
    summary = (
        ".item()/.cpu()/float()/nonzero on tensors inside a per-slot loop "
        "or a CUDA graph capture — forces a host sync every step"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        seen: set[int] = set()
        scopes: dict[int, tuple[set, set]] = {}
        for c in astutil.hot_contexts(module, imports):
            if id(c.scope) not in scopes:
                scopes[id(c.scope)] = (
                    astutil.param_names(c.scope),
                    astutil.numpy_names(c.scope, imports),
                )
            params, np_names = scopes[id(c.scope)]
            for node in astutil.walk_nodes(c.body):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                what = self._sync(imports, node, params, np_names)
                if what is None:
                    continue
                seen.add(id(node))
                yield self.finding(
                    ctx, node,
                    f"{what} inside a {c.kind} (line {c.node.lineno}) makes "
                    "the host wait for the card every step — keep the value "
                    "on the device, or read it once after the loop",
                )

    @staticmethod
    def _sync(imports, node: ast.Call, params, np_names) -> Optional[str]:
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in SYNC_METHODS
            and not node.args
            and not astutil.is_numpy_value(f.value, imports, np_names)
        ):
            return f".{f.attr}()"
        cn = imports.resolve(f)
        if cn in SYNC_CALLS:
            return cn
        if cn == ONE_HOT:
            k = astutil.get_arg(node, 1, "num_classes")
            if k is None or (isinstance(k, ast.UnaryOp) and ast.unparse(k) == "-1"):
                return f"{cn} without num_classes"
        if cn in PY_SCALAR_CASTS and len(node.args) == 1:
            arg = node.args[0]
            if astutil.is_numpy_value(arg, imports, np_names):
                return None
            # a parameter named like a module the file imports (chip_smoke
            # passes ``torch`` around) is that module, not a tensor
            casts = {
                n.id for n in ast.walk(arg) if isinstance(n, ast.Name)
            } & (params - np_names - set(imports.alias))
            if casts:
                return f"{cn}() of the argument '{ast.unparse(arg)}'"
        return None


@register
class ImpureGraphCapture(Rule):
    name = "impure-graph-capture"
    summary = (
        "python side effects (closure/attribute mutation, print) inside a "
        "CUDA graph capture — run once at capture, never at replay"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        for c in astutil.capture_contexts(module, imports):
            local = astutil.stored_names(c.body)
            if c.scope is c.node:
                local |= astutil.param_names(c.scope)
            line = c.node.lineno
            for node in astutil.walk_nodes(c.body):
                msg = self._side_effect(imports, node, local)
                if msg:
                    yield self.finding(
                        ctx, node,
                        f"{msg} inside the CUDA graph captured at line "
                        f"{line} runs once, at capture, and never at replay "
                        "— keep state in static tensors updated in place",
                    )

    @staticmethod
    def _side_effect(imports, node, local) -> Optional[str]:
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            return f"'{ast.unparse(node)}'"
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Attribute):
                    return f"attribute write '{ast.unparse(t)}'"
            return None
        if not isinstance(node, ast.Call):
            return None
        if imports.resolve(node.func) == "print":
            return "print()"
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATING_CONTAINER_METHODS:
            base = astutil.buffer_base(f.value)
            if base is not None and base not in local:
                return f"'{base}.{f.attr}(...)' on a closed-over container"
        return None
