"""Project-contract static analyzer (build/test-time only — never imported
by the runtime planes).

The project piled up load-bearing conventions that previously lived only in
comments and review heads: the seal-on-store CoW mutation discipline
(``mut()``/``touch()``), the signing-plane-only FrameContext aliasing rule,
``cxdrpack.getfield`` restricted to the TRUSTED post-verify plane,
quarantine-before-cache-latch in the async signature plane, and
VirtualClock determinism in consensus code.  The invariant plane
(``stellar_tpu_torch/invariant/``) catches the resulting bug classes at RUNTIME,
one forked close before the damage commits; this package catches them at
DIFF time, before the forked close ever runs — the same pairing the
reference gets from ``src/invariant/`` + its clang-tidy wiring.

Engine: one AST walk per audited module with a registry of rule visitors
(``rules.py``), a token-level C scanner for the GIL-release regions of the
native extensions (``crules.py``), per-site suppressions with MANDATORY
rationale strings, and JSON/human reports (``report.py``).  CLI:
``python -m stellar_tpu_torch.analysis [paths...]`` (also installed as
``stellar-tpu-torch-analyze``); exit 0 = clean, 1 = unsuppressed violations,
2 = a module failed to parse (a broken parse must never report clean).

Suppression syntax (same line or the line directly above)::

    f.entry.data.value = body  # analysis: off cow-mutation -- <why this site is safe>

A suppression without a rationale (no ``-- <text>``), or naming an unknown
rule, is itself a violation (``suppression-rationale``).  Lock-protected
fields register through a declaration-site comment::

    self._map = {}  # analysis: locked-by _lock

after which every access outside a ``with <lock>`` block (in any method
but ``__init__``) is a ``locked-field`` violation.

Tier-1 runs the analyzer over the live package and asserts zero
unsuppressed violations (tests/test_torch_analysis.py::test_analysis_clean);
the standing ROADMAP policy is that contract changes land with a rule or
an explicit rationale.
"""

from .core import FileContext, Report, Suppression, Violation, analyze_paths, analyze_source  # noqa: F401
from .registry import all_rules, rule_ids  # noqa: F401

# import for side effect: rule registration
from . import crules, rules  # noqa: F401, E402  isort:skip
