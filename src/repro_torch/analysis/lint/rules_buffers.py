"""Host-buffer discipline rules (counterpart of
``repro.analysis.lint.rules_buffers``): aliasing across an asynchronous
copy, and rebinding a tensor a CUDA graph captured.

The reference's serve engine once handed the device a *view* of its
mutable ``self.pending`` numpy buffer and mutated the buffer a few lines
later in the same method; the transfer was still in flight, so under load
the decode read the NEXT step's tokens. The port's torch shape of that
race is ``torch.from_numpy(buf).to(dev, non_blocking=True)`` followed by a
write into ``buf``: ``from_numpy`` shares the buffer's memory and the
non-blocking copy reads it later. ``serve/engine.py`` avoids it by
snapshotting with ``.copy()``; `aliased-buffer-dispatch` rejects the
un-snapshotted shape. The dispatch calls are ``torch.from_numpy``,
``torch.as_tensor``, ``torch.asarray`` (they share a numpy buffer's
memory), ``.to(..., non_blocking=True)`` / ``.cuda(non_blocking=True)``
and ``.pin_memory()`` (their receiver) and ``.copy_(src,
non_blocking=True)`` (its source).

`graph-static-rebind` replaces the reference's
`donation-use-after-dispatch` (eager torch donates no buffer): a name read
inside a CUDA graph capture and rebound by plain assignment later in the
same function. The graph replays on the storage it captured, so the new
tensor is never read; ``name.copy_(new)`` was needed.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.lint import astutil
from repro_torch.analysis.lint.core import Finding, FileContext, Rule, register

# method calls that return an independent buffer — the subtree below them
# cannot alias the argument handed to torch
SANITIZING_METHODS = {"copy", "astype", "tolist", "tobytes", "item", "clone"}
SANITIZING_CALLS = {
    "numpy.copy",
    "numpy.ascontiguousarray",
    "numpy.asfortranarray",
    "jax.device_get",
    "jax.numpy.array",
    # torch.tensor copies its data, unlike torch.as_tensor / from_numpy
    "torch.tensor",
}
# calls that share their first argument's memory with the tensor they return
SHARING_CALLS = {"torch.from_numpy", "torch.as_tensor", "torch.asarray"}
# in-place ndarray methods: proof the base is a mutable host buffer
MUTATING_METHODS = {"fill", "sort", "partition", "put", "itemset", "resize"}


def _dispatched(imports: astutil.Imports, call: ast.Call) -> list:
    """The expressions whose memory ``call`` hands on asynchronously (or
    shares), empty when it is not a dispatch."""
    if imports.resolve(call.func) in SHARING_CALLS:
        data = astutil.get_arg(call, 0, "data")
        if data is None:
            data = astutil.get_arg(call, 0, "obj")
        return [] if data is None else [data]
    f = call.func
    if not isinstance(f, ast.Attribute):
        return []
    non_blocking = astutil.keyword_is(call, "non_blocking", True)
    if f.attr in ("to", "cuda") and non_blocking:
        return [f.value]
    if f.attr == "pin_memory" and not call.args:
        return [f.value]
    if f.attr == "copy_" and non_blocking and call.args:
        return [call.args[0]]
    return []


def _label(imports: astutil.Imports, call: ast.Call) -> str:
    cn = imports.resolve(call.func)
    return cn if cn else f".{call.func.attr}()"


def _exposed_bases(
    imports: astutil.Imports, node: ast.expr
) -> Iterator[tuple[str, ast.expr]]:
    """Buffer bases reachable from an expression without passing through a
    copy. Yields (base name, the expression that exposes it)."""
    if isinstance(node, ast.Call):
        cn = imports.resolve(node.func)
        if cn in SANITIZING_CALLS:
            return
        if cn == "numpy.array":
            copy_kw = next(
                (kw.value for kw in node.keywords if kw.arg == "copy"), None
            )
            explicit_nocopy = (
                isinstance(copy_kw, ast.Constant) and copy_kw.value is False
            )
            if not explicit_nocopy:  # np.array copies by default
                return
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in SANITIZING_METHODS
        ):
            return
        recv = node.func.value if isinstance(node.func, ast.Attribute) else None
        if recv is not None and not (
            isinstance(recv, ast.Name) and recv.id in imports.alias
        ):
            # a method's receiver: x.reshape(...) is still x's memory
            yield from _exposed_bases(imports, recv)
        for a in node.args:
            yield from _exposed_bases(imports, a)
        for kw in node.keywords:
            yield from _exposed_bases(imports, kw.value)
        return
    base = astutil.buffer_base(node)
    if base is not None:
        yield base, node
        return
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.expr):
            yield from _exposed_bases(imports, child)


def _mutations(fn: ast.AST) -> dict[str, list[int]]:
    """base name -> lines where the buffer is mutated in place."""
    out: dict[str, list[int]] = {}

    def add(base: Optional[str], line: int) -> None:
        if base is not None:
            out.setdefault(base, []).append(line)

    for node in astutil.walk_scope(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    add(astutil.buffer_base(t), node.lineno)
        elif isinstance(node, ast.AugAssign):
            add(astutil.buffer_base(node.target), node.lineno)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and (
                f.attr in MUTATING_METHODS or astutil.in_place_method(node)
            ):
                add(astutil.buffer_base(f.value), node.lineno)
    return out


@register
class AliasedBufferDispatch(Rule):
    name = "aliased-buffer-dispatch"
    summary = (
        "mutable host buffer shared with a tensor or copied with "
        "non_blocking=True, then mutated in the same function — the copy "
        "may read the mutated bytes"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        for fn in astutil.functions(module):
            muts = _mutations(fn)
            if not muts:
                continue
            reported: set[tuple[str, int]] = set()
            for node in astutil.walk_scope(fn):
                if not isinstance(node, ast.Call):
                    continue
                end = node.end_lineno or node.lineno
                for expr in _dispatched(imports, node):
                    for base, _expr in _exposed_bases(imports, expr):
                        later = [m for m in muts.get(base, ()) if m > end]
                        if not later or (base, node.lineno) in reported:
                            continue
                        reported.add((base, node.lineno))
                        yield self.finding(
                            ctx, node,
                            f"'{base}' is handed to {_label(imports, node)} "
                            "without a "
                            f"snapshot and mutated later at line {later[0]}; "
                            "the asynchronous copy can read the mutated "
                            "bytes (the serve engine's decode race) — "
                            "snapshot with .copy() / .clone() / torch.tensor "
                            "before the copy",
                        )


@register
class GraphStaticRebind(Rule):
    name = "graph-static-rebind"
    summary = (
        "a tensor read by a CUDA graph capture is rebound after it — "
        "replays read the captured storage; write into it with .copy_()"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        for c in astutil.capture_contexts(module, imports):
            local = astutil.stored_names(c.body)
            if c.scope is c.node:  # a captured function: its own names
                local |= astutil.param_names(c.scope)
            reads = {
                n.id for n in astutil.walk_nodes(c.body)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            } - local
            flagged: set[str] = set()
            for node in astutil.walk_scope(c.anchor_scope):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                elif isinstance(node, ast.For):
                    targets = [node.target]
                else:
                    continue
                if node.lineno <= c.anchor_end:
                    continue
                for t in targets:
                    for n in ast.walk(t):
                        if (
                            isinstance(n, ast.Name)
                            and n.id in reads
                            and n.id not in flagged
                        ):
                            flagged.add(n.id)
                            yield self.finding(
                                ctx, n,
                                f"'{n.id}' was read by the CUDA graph "
                                f"captured at line {c.node.lineno} and is "
                                "rebound here; a replay reads the captured "
                                "storage, not the new tensor — write into "
                                f"it with {n.id}.copy_(...)",
                            )
