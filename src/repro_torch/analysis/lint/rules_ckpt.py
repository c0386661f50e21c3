"""Checkpoint durability rule (counterpart of
``repro.analysis.lint.rules_ckpt``; the same rule).

The reference's checkpoint once renamed its npz payload and its JSON
manifest into place with no durability barrier: a crash could publish a
manifest that vouched for payload bytes that were never fsynced. The
fixed protocol, which the port's ``ckpt/checkpoint.py`` follows too, is
payload-first: write the payload, ``fsync``, ``os.replace``, fsync the
directory, and only then publish the manifest the same way — the manifest
publish is the commit point.

`torn-publish` encodes the detectable core of that protocol: an
``os.replace`` / ``os.rename`` whose destination looks like a commit record
(manifest/meta/.json/index) appearing in a function with no ``os.fsync``
call before it.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.lint import astutil
from repro_torch.analysis.lint.core import Finding, FileContext, Rule, register

# destination substrings that mark a rename as publishing a commit record
MANIFEST_TOKENS = ("manifest", "meta", ".json", "index", "commit")

RENAMES = {"os.replace", "os.rename", "pathlib.Path.replace"}


@register
class TornPublish(Rule):
    name = "torn-publish"
    summary = (
        "manifest/metadata rename published with no fsync barrier earlier "
        "in the function — a crash can commit a manifest for undurable bytes"
    )

    def run(self, module: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        imports = astutil.imports_of(module)
        for fn in astutil.functions(module):
            calls = [
                n for n in astutil.walk_scope(fn) if isinstance(n, ast.Call)
            ]
            fsync_lines = [
                c.lineno
                for c in calls
                if imports.resolve(c.func) == "os.fsync"
            ]
            for c in calls:
                if imports.resolve(c.func) not in RENAMES:
                    continue
                if len(c.args) < 2:
                    continue
                dst = ast.unparse(c.args[1]).lower()
                if not any(tok in dst for tok in MANIFEST_TOKENS):
                    continue
                if any(line < c.lineno for line in fsync_lines):
                    continue
                yield self.finding(
                    ctx, c,
                    f"commit-record rename to '{ast.unparse(c.args[1])}' "
                    "with no os.fsync barrier earlier in this function — "
                    "the torn-checkpoint bug: make the payload durable "
                    "(write + fsync + replace + dir fsync) BEFORE publishing "
                    "the manifest that vouches for it",
                )
