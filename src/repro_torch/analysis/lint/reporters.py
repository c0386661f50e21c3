"""Finding reporters: grep-style text and machine-readable JSON (counterpart
of ``repro.analysis.lint.reporters``, the same report version and keys).

Text is the human/CI-log format (``path:line:col: rule: message``); JSON is
the artifact format, so finding counts are diffable from one run to the
next.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

from repro_torch.analysis.lint.core import RULES, Finding

REPORT_VERSION = 1


def render_text(findings: Sequence[Finding]) -> str:
    lines = [f.render() for f in findings]
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    if findings:
        summary = ", ".join(f"{k}={v}" for k, v in sorted(by_rule.items()))
        lines.append(f"{len(findings)} finding(s): {summary}")
    else:
        lines.append("clean: no findings")
    return "\n".join(lines)


def render_json(
    findings: Sequence[Finding], paths: Optional[Sequence[str]] = None
) -> str:
    doc = {
        "version": REPORT_VERSION,
        "paths": list(paths or []),
        "rules": {name: cls.summary for name, cls in sorted(RULES.items())},
        "count": len(findings),
        "findings": [f.to_dict() for f in findings],
    }
    return json.dumps(doc, indent=2)
