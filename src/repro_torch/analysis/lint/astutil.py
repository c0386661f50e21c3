"""Shared AST machinery for the PyTorch-aware lint rules (counterpart of
``repro.analysis.lint.astutil``).

Everything here is *syntactic*, as in the reference: the linter never
imports the code it analyses. What a name means is answered by resolving
local aliases through the file's own import statements (``import
torch.nn.functional as F`` makes ``F.one_hot`` canonical
``torch.nn.functional.one_hot``; ``from torch import cuda`` makes
``cuda.synchronize`` canonical ``torch.cuda.synchronize``). The rules
consume two views of a module:

* :class:`Imports` — alias-aware canonical-name resolution for dotted
  expressions;
* :func:`hot_contexts` — the code that runs once per step: a ``for ... in
  range(...)`` or ``while`` loop whose own body stores into a subscript,
  calls an in-place tensor method (a name ending in ``_``) or calls
  through ``ops.``, and the code captured into a CUDA graph
  (:func:`capture_contexts`: the body of ``with torch.cuda.graph(...)``
  and a function handed to ``torch.cuda.make_graphed_callables``).

Eager torch has no traced region: the reference's jitted functions and
``lax`` loop bodies become the port's per-slot Python loops, each of which
launches its kernels and returns to the host every iteration, and its
graph captures, which run their Python once and replay the kernels. The
analysis is per-module and not interprocedural, as in the reference.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional, Sequence, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class Imports:
    """Canonical-name resolution through the module's import aliases."""

    def __init__(self, module: ast.Module):
        self.alias: dict[str, str] = {}
        for node in all_nodes(module):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.alias[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.alias[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    if a.name != "*":
                        self.alias[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.expr) -> Optional[str]:
        """Dotted canonical name of an expression, or None if not a plain
        (possibly aliased) name chain. ``self.x`` resolves to ``self.x``."""
        if isinstance(node, ast.Name):
            return self.alias.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return None if base is None else f"{base}.{node.attr}"
        return None


def memo(node: ast.AST, key: str, make):
    """A view derived from ``node``, made once: every rule of a run reads
    the same parsed module, so each view walks it once, not once a rule."""
    cache = node.__dict__.setdefault("_lint_views", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def all_nodes(module: ast.Module) -> list[ast.AST]:
    """Every node of the module, in ``ast.walk`` order."""
    return memo(module, "nodes", lambda: list(ast.walk(module)))


def imports_of(module: ast.Module) -> Imports:
    return memo(module, "imports", lambda: Imports(module))


def get_arg(call: ast.Call, idx: int, name: str) -> Optional[ast.expr]:
    """Positional-or-keyword argument lookup on a Call node."""
    plain = [a for a in call.args if not isinstance(a, ast.Starred)]
    if len(plain) == len(call.args) and len(call.args) > idx:
        return call.args[idx]
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def keyword_is(call: ast.Call, name: str, value) -> bool:
    """True when ``call`` passes the literal ``value`` for keyword ``name``."""
    return any(
        kw.arg == name and isinstance(kw.value, ast.Constant)
        and kw.value.value is value
        for kw in call.keywords
    )


def functions(module: ast.Module) -> list[FunctionNode]:
    return memo(module, "functions", lambda: [
        node for node in all_nodes(module)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    ])


def walk_nodes(roots: Sequence[ast.AST]) -> Iterator[ast.AST]:
    """Walk ``roots`` and their descendants, not descending into nested
    function definitions or lambdas (their statements run when called, not
    where they are written)."""
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPES):
            continue
        stack.extend(ast.iter_child_nodes(node))


def walk_scope(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's own nodes, not descending into nested function
    definitions or lambdas."""
    return walk_nodes(list(ast.iter_child_nodes(fn)))


def parent_map(root: ast.AST) -> dict[int, ast.AST]:
    return memo(root, "parents", lambda: {
        id(child): parent
        for parent in (all_nodes(root) if isinstance(root, ast.Module)
                       else ast.walk(root))
        for child in ast.iter_child_nodes(parent)
    })


def enclosing_scope(pmap: dict[int, ast.AST], node: ast.AST) -> ast.AST:
    """The function or lambda whose body holds ``node``, else the module."""
    cur = pmap.get(id(node))
    while cur is not None and not isinstance(cur, _SCOPES):
        if isinstance(cur, ast.Module):
            return cur
        cur = pmap.get(id(cur))
    return cur


def param_names(fn: ast.AST) -> set[str]:
    if not isinstance(fn, _SCOPES):
        return set()
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def stored_names(nodes: Sequence[ast.AST]) -> set[str]:
    """Names bound by assignment, loop targets or ``with ... as`` among
    ``nodes`` (not inside nested functions)."""
    return {
        n.id for n in walk_nodes(nodes)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
    }


def buffer_base(node: ast.expr) -> Optional[str]:
    """The mutable-buffer identity of an lvalue-ish expression: peel
    subscripts, keep ``name`` or one-level ``obj.attr`` chains (the
    ``self.pending`` shape). Calls and deeper chains have no stable
    identity for the flow rules and return None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    return None


def in_place_method(call: ast.Call) -> Optional[str]:
    """The name of an in-place tensor method call (``index_add_``,
    ``copy_``, ``zero_``: a name ending in one underscore), else None."""
    f = call.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr.endswith("_")
        and not f.attr.startswith("_")
    ):
        return f.attr
    return None


def numpy_names(scope: ast.AST, imports: Imports) -> set[str]:
    """Names the scope binds to a numpy value: the result of a ``numpy.*``
    call or of a tensor's ``.numpy()``."""
    return memo(scope, "numpy_names", lambda: {
        t.id
        for node in walk_scope(scope)
        if isinstance(node, ast.Assign)
        and is_numpy_value(node.value, imports, set())
        for t in node.targets if isinstance(t, ast.Name)
    })


def is_numpy_value(node: ast.expr, imports: Imports, np_names: set[str]) -> bool:
    """True when ``node`` is visibly a numpy value: a ``numpy.*`` call, a
    ``.numpy()``, or a name in ``np_names``, through subscripts, attributes
    and method calls on it (``mask[i].any()``)."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            cn = imports.resolve(node.func) or ""
            if cn.startswith("numpy."):
                return True
            f = node.func
            if not isinstance(f, ast.Attribute):
                return False
            if f.attr == "numpy":
                return True
            node = f.value
        elif isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id in np_names
        else:
            return False


# -- per-step contexts -------------------------------------------------------

CAPTURE_CALLS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
GRAPHED_CALLABLES = {
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
}

LOOP = "per-step loop"
CAPTURE = "CUDA graph capture"


@dataclasses.dataclass
class Context:
    """Code that runs once per step (or once at capture, for a graph)."""

    node: ast.AST           # the loop, the ``with``, or the captured def
    body: list              # the nodes the step runs
    kind: str               # LOOP or CAPTURE
    scope: ast.AST          # the function (or module) the body's names live in
    # for captures: the scope the capture was made in and the line it ends
    # at; a name rebound there after that line was read by the capture
    anchor_scope: Optional[ast.AST] = None
    anchor_end: int = 0


def _steps_each_iteration(loop: ast.AST, imports: Imports, scope) -> bool:
    """The loop's own body stores into a subscript, calls an in-place
    tensor method, or calls through ``ops.``: a per-slot update. A store
    into a numpy array is host work (the float64 oracles) and does not
    count."""
    np_names = numpy_names(scope, imports)
    for node in walk_nodes(loop.body):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Store)
            and not is_numpy_value(node.value, imports, np_names)
        ):
            return True
        if isinstance(node, ast.Call):
            if in_place_method(node):
                return True
            cn = imports.resolve(node.func) or ""
            if "ops" in cn.split(".")[:-1]:
                return True
    return False


def _per_step_loops(module, imports) -> Iterator[Context]:
    pmap = parent_map(module)
    for node in all_nodes(module):
        if isinstance(node, ast.For):
            it = node.iter
            if not (
                isinstance(it, ast.Call) and imports.resolve(it.func) == "range"
            ):
                continue
        elif not isinstance(node, ast.While):
            continue
        scope = enclosing_scope(pmap, node)
        if _steps_each_iteration(node, imports, scope):
            yield Context(node, list(node.body), LOOP, scope)


def _defs_by_name(module: ast.Module) -> dict[str, list[FunctionNode]]:
    out: dict[str, list[FunctionNode]] = {}
    for node in functions(module):
        out.setdefault(node.name, []).append(node)
    return out


def capture_contexts(module: ast.Module, imports: Imports) -> list[Context]:
    """The code a CUDA graph captures: ``with torch.cuda.graph(...)`` bodies
    and the functions (defs or lambdas, alone or in a tuple) passed to
    ``torch.cuda.make_graphed_callables``."""
    return memo(module, "captures", lambda: _captures(module, imports))


def _captures(module: ast.Module, imports: Imports) -> list[Context]:
    pmap = parent_map(module)
    defs = _defs_by_name(module)
    out: list[Context] = []
    for node in all_nodes(module):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            if any(
                isinstance(it.context_expr, ast.Call)
                and imports.resolve(it.context_expr.func) in CAPTURE_CALLS
                for it in node.items
            ):
                scope = enclosing_scope(pmap, node)
                out.append(Context(node, list(node.body), CAPTURE, scope,
                                   scope, node.end_lineno or node.lineno))
        elif (
            isinstance(node, ast.Call)
            and imports.resolve(node.func) in GRAPHED_CALLABLES
        ):
            arg = get_arg(node, 0, "callables")
            fns = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
            anchor = enclosing_scope(pmap, node)
            for fn in fns:
                if isinstance(fn, ast.Lambda):
                    bodies = [fn]
                elif isinstance(fn, ast.Name):
                    bodies = defs.get(fn.id, [])
                else:
                    bodies = []
                for b in bodies:
                    body = [b.body] if isinstance(b, ast.Lambda) else list(b.body)
                    out.append(Context(b, body, CAPTURE, b, anchor,
                                       node.end_lineno or node.lineno))
    return out


def hot_contexts(module: ast.Module, imports: Imports) -> list[Context]:
    """Per-step loops and graph captures (replaces the reference's
    ``jitted_contexts``). Contexts may nest: a rule reports a node once."""
    return list(_per_step_loops(module, imports)) + capture_contexts(
        module, imports
    )
