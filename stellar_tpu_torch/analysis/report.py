"""Report rendering: human text and machine JSON for the analyzer CLI."""

from __future__ import annotations

import json

from .core import Report
from .registry import rule_docs


def render_human(report: Report, verbose_suppressions: bool = False) -> str:
    out = []
    for path, err in report.parse_errors:
        out.append(f"{path}: PARSE ERROR: {err}")
    for v in report.violations:
        out.append(v.render())
    if verbose_suppressions and report.suppressed:
        out.append("")
        out.append("suppressed (each carries a reviewed rationale):")
        for s in report.suppressed:
            out.append(
                f"  {s.path}:{s.line}: [{s.rule}] -- {s.rationale}"
            )
    out.append(
        f"{len(report.violations)} violation(s),"
        f" {len(report.suppressed)} suppressed,"
        f" {len(report.parse_errors)} parse error(s);"
        f" {report.files_scanned} file(s) scanned,"
        f" {len(report.rules)} rules active"
    )
    return "\n".join(out)


def render_json(report: Report) -> str:
    return json.dumps(report.to_json(), indent=1, sort_keys=True)


def render_rules() -> str:
    width = max(len(rid) for rid, _ in rule_docs())
    return "\n".join(f"{rid.ljust(width)}  {doc}" for rid, doc in rule_docs())
