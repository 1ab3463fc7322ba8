"""Deliberate-corruption injections for the invariant plane.

Each helper returns a one-shot hook for
``InvariantManager.inject_once``: it runs INSIDE the next checked close
(after the store-buffer flush, immediately before the invariants) with
that close's ``InvariantContext``, and corrupts exactly one plane —
the SQL rows, the delta's entry snapshots, or the decoded-entry cache —
so a test can prove the paired invariant detects its failure class.

The corruptions target a changed ACCOUNT entry of the close (every
close that applies a payment has one); they raise if the close touched
no account, so a mis-sequenced test fails loudly instead of silently
injecting nothing.

Tests normally enable ONLY the invariant under test
(``cfg.INVARIANT_CHECKS = ["ConservationOfLumens"]`` etc.) — several of
these corruptions are visible to more than one invariant by design
(that overlap is the plane's defense in depth, not a test bug).
"""

from __future__ import annotations

from ..xdr.base import xdr_copy
from ..xdr.entries import LedgerEntryType


def _pick_changed_account(ctx):
    """(key, entry) of the first changed ACCOUNT entry, deterministic."""
    for key, entry, _created in ctx.delta.iter_changed():
        if key.type == LedgerEntryType.ACCOUNT:
            return key, entry
    raise AssertionError(
        "injection needs a close that changed at least one account"
    )


def corrupt_sql_balance(amount: int = 12345):
    """UPDATE a changed account's SQL row balance without telling any
    other plane — breaks conservation (the whole-ledger sum) and the
    SQL half of cache<->DB consistency.  Runs inside the close's open
    transaction, so an aborted close rolls the corruption back too."""

    def inject(ctx):
        from ..crypto import strkey

        key, entry = _pick_changed_account(ctx)
        aid = strkey.to_account_strkey(key.value.accountID.value)
        ctx.db.execute(
            "UPDATE accounts SET balance = balance + ? WHERE accountid=?",
            (amount, aid),
        )

    return inject


def corrupt_subentry_count(delta: int = 1):
    """Bump a changed account's ``numSubEntries`` in the delta snapshot
    (shared with the entry cache) without creating the matching
    subentry — AccountSubEntriesCountIsValid's failure class."""

    def inject(ctx):
        _key, entry = _pick_changed_account(ctx)
        entry.data.value.numSubEntries += delta

    return inject


def desync_cache_balance(amount: int = 777):
    """Replace a changed account's decoded-entry cache line with a copy
    whose balance differs from both the delta and SQL — the
    cache-plane half of CacheIsConsistentWithDatabase."""

    def inject(ctx):
        from ..ledger.entryframe import entry_cache_of, key_bytes

        key, entry = _pick_changed_account(ctx)
        bad = xdr_copy(entry)
        bad.data.value.balance += amount
        entry_cache_of(ctx.db).put_owned(key_bytes(key), bad)

    return inject


def malform_entry():
    """Truncate a changed account's thresholds to a single byte in the
    delta snapshot — a structurally invalid entry LedgerEntryIsValid
    must refuse to let commit."""

    def inject(ctx):
        _key, entry = _pick_changed_account(ctx)
        entry.data.value.thresholds = b"\x01"

    return inject
