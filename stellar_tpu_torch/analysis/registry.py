"""Rule registry: rules self-register at import via the ``@register``
decorator; the engine and CLI enumerate them through ``all_rules()``.

``suppression-rationale`` is the engine's own meta rule (bare or
unknown-rule suppressions, malformed locked-by registrations) — it has no
visitor class but must be a known id, so it is seeded here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List


class Rule:
    """Base rule.  Subclasses set ``id``/``doc`` and implement ``check``;
    ``applies`` gates by module (path scope, or content probes like 'does
    this module reference the guarded type at all')."""

    id: str = ""
    doc: str = ""
    is_c_rule: bool = False

    def applies(self, ctx) -> bool:
        return True

    def check(self, ctx) -> Iterator:
        raise NotImplementedError


_RULES: Dict[str, Rule] = {}

# engine-level meta rule id (core.py emits it directly)
META_RULE_ID = "suppression-rationale"
META_RULE_DOC = (
    "suppressions must carry a rationale ('-- <why>') and name a real rule;"
    " locked-by registrations must sit on the field declaration line"
)


def register(cls):
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _RULES or inst.id == META_RULE_ID:
        raise ValueError(f"duplicate rule id {inst.id!r}")
    _RULES[inst.id] = inst
    return cls


def all_rules() -> List[Rule]:
    return [_RULES[k] for k in sorted(_RULES)]


def rule_ids() -> List[str]:
    return sorted(_RULES) + [META_RULE_ID]


def rule_docs() -> List[tuple]:
    out = [(r.id, r.doc) for r in all_rules()]
    out.append((META_RULE_ID, META_RULE_DOC))
    return sorted(out)
