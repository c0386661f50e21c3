"""Rule registry, suppression handling, and the lint entry points
(counterpart of ``repro.analysis.lint.core``; the same registry,
suppression syntax and finding format).

A rule is a class with a ``name`` (kebab-case, the suppression token), a
``summary`` (one line, shown by ``--list-rules``) and a ``run(module, ctx)``
generator of :class:`Finding`. Registration is a decorator::

    @register
    class MyRule(Rule):
        name = "my-rule"
        summary = "what discipline this enforces"
        def run(self, module, ctx):
            yield self.finding(ctx, node, "message")

Suppression: a ``# lint: disable=rule-a,rule-b`` comment on the flagged
line (or on a comment-only line directly above it) silences those rules for
that line; ``disable=all`` silences every rule. ``# lint: skip-file`` in
the first ten lines skips the whole file. Suppressions are for *intentional*
instances of a pattern (a test reproducing a historical bug); fixes are for
everything else.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator, Optional, Sequence

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([\w\-, ]+)")
_SKIP_RE = re.compile(r"#\s*lint:\s*skip-file\b")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


class FileContext:
    """Per-file state shared by the rules: source lines + suppressions."""

    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path
        self.lines = source.splitlines()
        self.disabled: dict[int, set[str]] = {}
        self.comment_only: set[int] = set()
        self.skip_file = False
        for i, ln in enumerate(self.lines, 1):
            m = _DISABLE_RE.search(ln)
            if m:
                self.disabled[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            if ln.lstrip().startswith("#"):
                self.comment_only.add(i)
            if i <= 10 and _SKIP_RE.search(ln):
                self.skip_file = True

    def suppressed(self, f: Finding) -> bool:
        rules = set(self.disabled.get(f.line, ()))
        prev = f.line - 1
        if prev in self.comment_only:
            rules |= self.disabled.get(prev, set())
        return bool(rules) and (f.rule in rules or "all" in rules)


class Rule:
    name: str = ""
    summary: str = ""

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        return Finding(
            path=ctx.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            rule=self.name,
            message=message,
        )


RULES: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    assert cls.name and cls.name not in RULES, cls
    RULES[cls.name] = cls
    return cls


def _selected(rules: Optional[Iterable[str]]) -> list[type[Rule]]:
    if rules is None:
        return [RULES[k] for k in sorted(RULES)]
    unknown = set(rules) - set(RULES)
    if unknown:
        raise KeyError(f"unknown rule(s): {sorted(unknown)}")
    return [RULES[k] for k in sorted(rules)]


def lint_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Iterable[str]] = None,
) -> list[Finding]:
    """Lint one source string; returns sorted, suppression-filtered findings."""
    try:
        module = ast.parse(source)
    except SyntaxError as e:
        return [
            Finding(path, e.lineno or 0, e.offset or 0, "syntax-error",
                    f"could not parse: {e.msg}")
        ]
    ctx = FileContext(source, path)
    if ctx.skip_file:
        return []
    out: list[Finding] = []
    for cls in _selected(rules):
        out.extend(cls().run(module, ctx))
    return sorted(f for f in out if not ctx.suppressed(f))


def lint_file(path: str, rules: Optional[Iterable[str]] = None) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path, rules)


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if d != "__pycache__" and not d.startswith(".")
            )
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(
    paths: Sequence[str], rules: Optional[Iterable[str]] = None
) -> list[Finding]:
    """Lint every .py file under ``paths`` (files or directory trees)."""
    out: list[Finding] = []
    for p in iter_py_files(paths):
        out.extend(lint_file(p, rules))
    return sorted(out)
