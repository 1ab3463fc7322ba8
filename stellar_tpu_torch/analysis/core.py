"""Analyzer engine: file contexts, suppressions, the rule runner.

One parse + one parent-annotated walk per Python module; rules are small
visitors over that shared context (``FileContext``).  C sources get a
line/comment scan instead of an AST (see crules.py).  All state is
per-run — the engine is import-light and never touched by the runtime
planes (profile_close.py --assert-budget pins that).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .registry import all_rules, rule_ids

# -- suppression / registry comment grammar ---------------------------------

# "# analysis: off <rule-id> -- <rationale>"; the rationale is MANDATORY —
# a suppression is a reviewed exception, and the review lives in the text
_SUPPRESS_RE = re.compile(
    r"analysis:\s*off\s+(?P<rule>[\w-]+)(?:\s+--\s*(?P<rationale>.*?))?\s*(?:\*/)?\s*$"
)
# "# analysis: locked-by <lock>" on a field's declaration line registers
# the field into the locked-field rule's registry for that module
_LOCKED_RE = re.compile(r"analysis:\s*locked-by\s+(?P<lock>\w+)")
_DECL_RE = re.compile(r"self\.(?P<field>\w+)\s*(?::[^=]+)?=")


@dataclass
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "rule": self.rule,
            "message": self.message,
        }


@dataclass
class Suppression:
    path: str
    line: int
    rule: str
    rationale: str
    comment_line: int  # where the comment itself sits (== line for trailing)

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "rule": self.rule,
            "rationale": self.rationale,
        }


@dataclass
class FileContext:
    """Everything a rule needs about one audited file."""

    path: str  # as given / display
    relpath: str  # package-relative, '/'-separated (rule scoping key)
    text: str
    lines: List[str]
    tree: Optional[ast.AST]  # None for C sources / parse failures
    comments: Dict[int, str] = field(default_factory=dict)  # line -> text
    # line -> {rule: (rationale, comment_line)}; a violation on line L is
    # suppressed by an entry at L (trailing comment) or registered FROM an
    # own-line comment above (attaches to the next CODE line, skipping
    # blanks and wrapped-rationale comment continuations)
    suppress: Dict[int, Dict[str, Tuple[str, int]]] = field(default_factory=dict)
    locked: Dict[str, Tuple[str, int]] = field(default_factory=dict)  # field -> (lock, decl line)
    meta_violations: List[Tuple[int, str]] = field(default_factory=list)
    is_c: bool = False

    # -- AST helpers shared by the rules ------------------------------------
    def ancestors(self, node: ast.AST):
        n = getattr(node, "_an_parent", None)
        while n is not None:
            yield n
            n = getattr(n, "_an_parent", None)

    def enclosing_function(self, node: ast.AST) -> Optional[str]:
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a.name
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[str]:
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a.name
        return None

    def in_with_lock(self, node: ast.AST, lock: str) -> bool:
        """True when an ancestor ``with`` statement's context expression
        names `lock` as a whole attribute/name token (``self._lock`` holds
        ``_lock``; ``self._wedge_lock`` does NOT — no substring passes)."""
        pat = re.compile(rf"\b{re.escape(lock)}\b")
        for a in self.ancestors(node):
            if isinstance(a, (ast.With, ast.AsyncWith)):
                for item in a.items:
                    try:
                        src = ast.unparse(item.context_expr)
                    except Exception:  # pragma: no cover - unparse is total on parsed trees
                        continue
                    if pat.search(src):
                        return True
        return False


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``self.entry.data.value`` -> ['self','entry','data','value'];
    call links keep their name with ``()`` (``f.mut().balance`` ->
    ['f','mut()','balance']).  None when the base isn't a plain
    name/attribute/call chain (subscripts etc. end the walk)."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                parts.append(f.attr + "()")
                node = f.value
            elif isinstance(f, ast.Name):
                parts.append(f.id + "()")
                break
            else:
                return None
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            return None
    parts.reverse()
    return parts


@dataclass
class Report:
    violations: List[Violation] = field(default_factory=list)
    suppressed: List[Suppression] = field(default_factory=list)
    parse_errors: List[Tuple[str, str]] = field(default_factory=list)  # (path, err)
    files_scanned: int = 0
    rules: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.violations and not self.parse_errors

    def exit_code(self) -> int:
        """2 = parse errors (a tree we could not audit must never report
        clean), 1 = unsuppressed violations, 0 = clean."""
        if self.parse_errors:
            return 2
        return 1 if self.violations else 0

    def to_json(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "rules": self.rules,
            "violations": [v.to_json() for v in self.violations],
            "suppressions": [s.to_json() for s in self.suppressed],
            "parse_errors": [
                {"path": p, "error": e} for p, e in self.parse_errors
            ],
            "clean": self.clean,
        }


# -- context construction ----------------------------------------------------


def _collect_py_comments(text: str) -> Dict[int, str]:
    """line -> comment text, via tokenize (a '#' inside a string is not a
    comment).  On tokenize errors fall back to nothing — the AST parse
    reports the real problem."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def _collect_c_comments(lines: List[str]) -> Dict[int, str]:
    """Good-enough C comment grab for the suppression/registry grammar:
    any line containing the 'analysis:' marker contributes its tail."""
    out: Dict[int, str] = {}
    for i, ln in enumerate(lines, 1):
        if "analysis:" in ln:
            m = re.search(r"(?://|/\*|#)?\s*(analysis:.*)$", ln)
            if m:
                out[i] = m.group(1)
    return out


def _line_has_code(lines: List[str], lineno: int) -> bool:
    if not (1 <= lineno <= len(lines)):
        return False
    code = lines[lineno - 1].split("#", 1)[0].strip()
    return bool(code) and not code.startswith(("//", "/*", "*"))


def _next_code_line(lines: List[str], lineno: int, limit: int = 10) -> int:
    """The line an own-line suppression attaches to: the next line that
    carries CODE, skipping blanks and further comment lines (a wrapped
    rationale continuation must not swallow the suppression) — bounded so
    a trailing comment block can't attach to something far away."""
    for cand in range(lineno + 1, min(lineno + 1 + limit, len(lines) + 1)):
        if _line_has_code(lines, cand):
            return cand
    return lineno + 1


def build_context(path: str, relpath: str, text: str) -> FileContext:
    is_c = relpath.endswith(".c")
    lines = text.splitlines()
    ctx = FileContext(
        path=path, relpath=relpath, text=text, lines=lines, tree=None, is_c=is_c
    )
    ctx.comments = _collect_c_comments(lines) if is_c else _collect_py_comments(text)
    known = set(rule_ids())
    for lineno, comment in sorted(ctx.comments.items()):
        m = _SUPPRESS_RE.search(comment)
        if m:
            rule = m.group("rule")
            rationale = (m.group("rationale") or "").strip()
            target = (
                lineno
                if _line_has_code(lines, lineno)
                else _next_code_line(lines, lineno)
            )
            if rule not in known:
                ctx.meta_violations.append(
                    (lineno, f"suppression names unknown rule {rule!r}")
                )
            elif not rationale:
                ctx.meta_violations.append(
                    (
                        lineno,
                        f"bare suppression of {rule!r} — a rationale is"
                        " mandatory (… off "
                        f"{rule} -- <why this site is safe>)",
                    )
                )
            else:
                ctx.suppress.setdefault(target, {})[rule] = (rationale, lineno)
        m = _LOCKED_RE.search(comment)
        if m and not is_c:
            dm = _DECL_RE.search(lines[lineno - 1]) if lineno <= len(lines) else None
            if dm:
                ctx.locked[dm.group("field")] = (m.group("lock"), lineno)
            else:
                ctx.meta_violations.append(
                    (
                        lineno,
                        "locked-by registry comment must sit on the"
                        " field's `self.<field> = ...` declaration line",
                    )
                )
    if not is_c:
        tree = ast.parse(text)  # SyntaxError propagates to the runner
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                child._an_parent = parent
        ctx.tree = tree
    return ctx


# -- the runner --------------------------------------------------------------


def _relpath_of(path: str) -> str:
    """Package-relative path used for rule scoping: the portion after the
    LAST 'stellar_tpu' or 'stellar_tpu_torch' segment, '/'-separated; else
    the basename."""
    norm = os.path.normpath(os.path.abspath(path)).replace(os.sep, "/")
    parts = norm.split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] in ("stellar_tpu", "stellar_tpu_torch"):
            return "/".join(parts[i + 1 :])
    return parts[-1]


def _audit_context(ctx: FileContext, report: Report) -> None:
    fired = []
    for rule in all_rules():
        if rule.is_c_rule != ctx.is_c:
            continue
        if not rule.applies(ctx):
            continue
        for line, message in rule.check(ctx):
            fired.append((line, rule.id, message))
    for line, msg in ctx.meta_violations:
        fired.append((line, "suppression-rationale", msg))
    used = set()
    for line, rule_id, message in sorted(fired):
        sup = ctx.suppress.get(line, {}).get(rule_id)
        if sup is not None and rule_id != "suppression-rationale":
            rationale, comment_line = sup
            used.add((line, rule_id))
            report.suppressed.append(
                Suppression(ctx.path, line, rule_id, rationale, comment_line)
            )
        else:
            report.violations.append(Violation(ctx.path, line, rule_id, message))
    # the unused-noqa pattern: a suppression whose violation no longer
    # fires is stale — it would silently pre-suppress a future regression
    # on that line and drift the SWEEP.md inventory, so it fails the gate
    for line, by_rule in sorted(ctx.suppress.items()):
        for rule_id, (_rationale, comment_line) in sorted(by_rule.items()):
            if (line, rule_id) not in used:
                report.violations.append(
                    Violation(
                        ctx.path,
                        comment_line,
                        "suppression-rationale",
                        f"unused suppression of {rule_id!r} — the violation"
                        " it silenced no longer fires; delete the comment",
                    )
                )


def analyze_source(
    text: str, relpath: str, report: Optional[Report] = None, path: Optional[str] = None
) -> Report:
    """Audit one source text under a (possibly virtual) package-relative
    path — the fixture tests drive path-scoped rules through this."""
    if report is None:
        report = Report(rules=rule_ids())
    try:
        ctx = build_context(path or relpath, relpath, text)
    except SyntaxError as e:
        report.parse_errors.append((path or relpath, f"line {e.lineno}: {e.msg}"))
        report.files_scanned += 1
        return report
    except ValueError as e:
        # ast.parse raises bare ValueError for e.g. NUL bytes in the
        # source — still a file we could not audit, never a clean pass
        report.parse_errors.append((path or relpath, str(e)))
        report.files_scanned += 1
        return report
    _audit_context(ctx, report)
    report.files_scanned += 1
    return report


def iter_audit_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d not in ("__pycache__", ".git")
                )
                for name in sorted(files):
                    if name.endswith((".py", ".c")):
                        out.append(os.path.join(root, name))
        else:
            out.append(p)
    return out


def analyze_paths(paths: Iterable[str]) -> Report:
    report = Report(rules=rule_ids())
    for fp in iter_audit_files(paths):
        try:
            with open(fp, "r", encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError as e:
            report.parse_errors.append((fp, str(e)))
            continue
        analyze_source(text, _relpath_of(fp), report, path=fp)
    return report
