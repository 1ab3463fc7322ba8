"""Pluggable ledger-invariant plane (reference: src/invariant/).

A registry of close-time safety checks — conservation of lumens,
subentry-count accounting, per-entry structural validity, and
cache<->database consistency — executed by ``InvariantManager`` against
the ledger delta after apply/flush and before commit, so a violation
aborts the close instead of persisting a forked ledger.  See
``manager.py`` for the knobs and wiring, ``testing.py`` for the
deliberate-corruption injection API.
"""

from .invariants import (
    ALL_INVARIANTS,
    AccountSubEntriesCountIsValid,
    CacheIsConsistentWithDatabase,
    CloseBaseline,
    ConservationOfLumens,
    Invariant,
    InvariantContext,
    InvariantViolation,
    LedgerEntryIsValid,
    resolve_invariants,
)
from .manager import FAIL_POLICIES, InvariantManager

__all__ = [
    "ALL_INVARIANTS",
    "AccountSubEntriesCountIsValid",
    "CacheIsConsistentWithDatabase",
    "CloseBaseline",
    "ConservationOfLumens",
    "FAIL_POLICIES",
    "Invariant",
    "InvariantContext",
    "InvariantManager",
    "InvariantViolation",
    "LedgerEntryIsValid",
    "resolve_invariants",
]
