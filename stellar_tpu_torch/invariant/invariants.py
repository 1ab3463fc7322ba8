"""Ledger invariants (reference: src/invariant/ — Invariant.h,
ConservationOfLumens.cpp, AccountSubEntriesCountIsValid.cpp,
LedgerEntryIsValid.cpp, CacheIsConsistentWithDatabase.cpp).

Each invariant is a pure check over the state a just-applied ledger close
is about to commit: the LedgerDelta (changed/deleted entries + header
mutation), the flushed SQL rows, and the decoded-entry cache.  They run
from ``LedgerManager._close_ledger_txn`` AFTER the store-buffer flush and
the PARANOID audit but BEFORE ``delta.commit()`` and the SQL COMMIT — a
violation under the ``raise`` fail policy therefore aborts the close (the
enclosing transaction rolls back and the entry cache is dropped wholesale)
instead of persisting a forked ledger.

The checks are deliberately relay/backend-independent: they guard exactly
the planes the perf levers alias — the FrameContext identity map, the
entry store buffer, and the decoded-entry cache — so every future
copy-elision PR inherits an always-on differential oracle.

``check`` returns ``None`` when satisfied or a human-readable violation
message; it must NOT mutate ledger state (cache-line erase + reload from
SQL truth is the one sanctioned side effect, same as the PARANOID audit).
"""

from __future__ import annotations

from typing import List, Optional

from ..util.xmath import INT64_MAX
from ..xdr.entries import LedgerEntryType


class InvariantViolation(RuntimeError):
    """An enabled ledger invariant does not hold for the close being
    committed.  Raised (fail policy ``raise``) out of the close's SQL
    transaction scope, so the close aborts and nothing persists."""

    def __init__(self, failures):
        self.failures = list(failures)  # [(invariant_name, message)]
        super().__init__(
            "; ".join(f"{name}: {msg}" for name, msg in self.failures)
        )


# the whole-ledger balance scan: the close-start baseline and the
# post-close drift check MUST sum the same expression over the same
# table, or conservation's burn-drift comparison silently breaks
_SUM_BALANCES_SQL = "SELECT COALESCE(SUM(balance), 0) FROM accounts"


def sum_native_balances(db) -> int:
    row = db.query_one(_SUM_BALANCES_SQL)
    return row[0] if row else 0


class CloseBaseline:
    """The state conservation reasons over, snapshotted at close START
    (before fee processing, before any close write): header totals, plus
    — in all-on mode — the whole-ledger balance sum.  Within-close deltas
    are measured against THIS, not the last closed header: the direct
    -apply test idiom mutates the working header and SQL rows between
    closes, and those out-of-band edits are not the close's doing."""

    __slots__ = ("totalCoins", "feePool", "inflationSeq", "sum_balances")

    def __init__(self, total_coins: int, fee_pool: int, inflation_seq: int,
                 sum_balances: Optional[int] = None):
        self.totalCoins = total_coins
        self.feePool = fee_pool
        self.inflationSeq = inflation_seq
        self.sum_balances = sum_balances

    @classmethod
    def of(cls, header, db=None) -> "CloseBaseline":
        sum_balances = None
        if db is not None:
            sum_balances = sum_native_balances(db)
        return cls(
            header.totalCoins, header.feePool, header.inflationSeq,
            sum_balances,
        )


class InvariantContext:
    """Everything one close hands the invariant plane (the analogue of the
    reference's per-invariant checkOnOperationApply arguments, hoisted to
    once-per-close granularity)."""

    __slots__ = (
        "app", "db", "delta", "header", "pre", "txs",
        "sampled", "sample_cap", "rng", "_changed",
    )

    def __init__(self, app, db, delta, header, pre, txs,
                 sampled, sample_cap, rng):
        self.app = app
        self.db = db
        self.delta = delta
        self.header = header  # post-apply header (read-only view)
        self.pre = pre        # CloseBaseline at close start (may be None)
        self.txs = txs        # applied TransactionFrames, in order
        self.sampled = sampled
        self.sample_cap = sample_cap
        self.rng = rng        # seeded per close (deterministic)
        self._changed = None

    def changed_entries(self):
        """[(LedgerKey, LedgerEntry, created)] for this close — built once
        and shared by every invariant (the delta is frozen while the
        checks run, and three of the four invariants walk this list)."""
        if self._changed is None:
            self._changed = list(self.delta.iter_changed())
        return self._changed

    def sample(self, items: list) -> list:
        """The whole list in all-on mode; at most ``sample_cap`` random
        (seeded) picks in sampled mode."""
        if not self.sampled or len(items) <= self.sample_cap:
            return items
        return self.rng.sample(items, self.sample_cap)


class Invariant:
    name = "?"

    def check(self, ctx: InvariantContext) -> Optional[str]:
        raise NotImplementedError


def _aid(pk) -> str:
    from ..crypto import strkey

    return strkey.to_account_strkey(pk.value)


def _load_fresh(db, key):
    """Re-read one entry straight from SQL, bypassing the decoded-entry
    cache — the shared erase-then-load dispatch in ledger/delta.py, also
    used by the PARANOID_MODE check_against_database audit."""
    from ..ledger.delta import load_fresh_entry

    return load_fresh_entry(db, key)


class ConservationOfLumens(Invariant):
    """Native lumens are never MINTED by a close (ConservationOfLumens.cpp,
    adapted to the reference's pinned semantics): totalCoins moves only
    when inflation runs, the feePool delta of an inflation-less close
    equals exactly the fees charged, and — all-on mode, where the close
    baseline carries a whole-ledger balance sum — the burn drift
    ``totalCoins - (sum(balances) + feePool)`` must not SHRINK across the
    close.

    Not-shrink, not zero-delta: the reference DESTROYS lumens on a self
    path-payment — the destination credit is overwritten by the stale
    source handle's debit (the consensus-pinned interleave differential-
    tested in tests/test_framecontext.py::test_differential_self_path_
    payment) — so the drift legitimately grows on such closes.  A shrink
    means lumens appeared from nowhere, which is exactly the aliasing-bug
    signature this plane exists to catch: a stale frame resurrecting an
    overwritten balance, a double-applied credit, a corrupt row."""

    name = "ConservationOfLumens"

    def check(self, ctx: InvariantContext) -> Optional[str]:
        h, pre = ctx.header, ctx.pre
        if pre is None:
            return None  # no start snapshot: nothing to delta against
        inflated = h.inflationSeq != pre.inflationSeq
        if not inflated:
            if h.totalCoins != pre.totalCoins:
                return (
                    f"totalCoins changed without inflation: "
                    f"{pre.totalCoins} -> {h.totalCoins}"
                )
            if ctx.txs is not None:
                fees = sum(tx.result.feeCharged for tx in ctx.txs)
                if h.feePool - pre.feePool != fees:
                    return (
                        f"feePool delta {h.feePool - pre.feePool} != fees "
                        f"charged {fees} over {len(ctx.txs)} txs"
                    )
        # the full-table sum is the expensive half: the manager only puts
        # sum_balances on the baseline in all-on mode (sampled keeps the
        # exact header checks above and skips both scans).  Inflated
        # closes are exempt from the drift check too — the reference
        # parks the UNDOLED inflation amount in feePool without minting
        # it into totalCoins (no-winner case), a legitimate shrink; the
        # inflation suite oracles those balances exactly.
        if pre.sum_balances is None or inflated:
            return None
        total_balances = sum_native_balances(ctx.db)
        drift_start = pre.totalCoins - (pre.sum_balances + pre.feePool)
        drift_end = h.totalCoins - (total_balances + h.feePool)
        if drift_end < drift_start:
            return (
                f"lumens minted within the close: sum(balances) "
                f"{total_balances} + feePool {h.feePool} vs totalCoins "
                f"{h.totalCoins} — burn drift shrank {drift_start} -> "
                f"{drift_end}"
            )
        return None


class AccountSubEntriesCountIsValid(Invariant):
    """Every changed account's ``numSubEntries`` equals its actual signer
    + trustline + offer count (AccountSubEntriesCountIsValid.cpp), counted
    against the flushed SQL rows; a deleted account must leave no
    subentry rows behind."""

    name = "AccountSubEntriesCountIsValid"

    def _actual_counts(self, db, aid: str):
        n_tl = db.query_one(
            "SELECT COUNT(*) FROM trustlines WHERE accountid=?", (aid,)
        )[0]
        n_of = db.query_one(
            "SELECT COUNT(*) FROM offers WHERE sellerid=?", (aid,)
        )[0]
        n_sg = db.query_one(
            "SELECT COUNT(*) FROM signers WHERE accountid=?", (aid,)
        )[0]
        return n_sg, n_tl, n_of

    def check(self, ctx: InvariantContext) -> Optional[str]:
        accounts = [
            (key, entry)
            for key, entry, _created in ctx.changed_entries()
            if key.type == LedgerEntryType.ACCOUNT
        ]
        for key, entry in ctx.sample(accounts):
            a = entry.data.value
            aid = _aid(a.accountID)
            n_sg, n_tl, n_of = self._actual_counts(ctx.db, aid)
            if len(a.signers) != n_sg:
                return (
                    f"account {aid[:8]}..: entry carries {len(a.signers)} "
                    f"signer(s) but the signers table has {n_sg}"
                )
            expected = n_sg + n_tl + n_of
            if a.numSubEntries != expected:
                return (
                    f"account {aid[:8]}..: numSubEntries={a.numSubEntries} "
                    f"but signers+trustlines+offers = "
                    f"{n_sg}+{n_tl}+{n_of} = {expected}"
                )
        deleted = [
            key for key in ctx.delta.iter_deleted()
            if key.type == LedgerEntryType.ACCOUNT
        ]
        for key in ctx.sample(deleted):
            aid = _aid(key.value.accountID)
            n_sg, n_tl, n_of = self._actual_counts(ctx.db, aid)
            if n_sg or n_tl or n_of:
                return (
                    f"deleted account {aid[:8]}.. left "
                    f"{n_sg}+{n_tl}+{n_of} subentry row(s) behind"
                )
        return None


class LedgerEntryIsValid(Invariant):
    """Structural/field-range validity of every changed entry
    (LedgerEntryIsValid.cpp): stamped lastModified, int64 balance bounds,
    4-byte thresholds, canonical signer order, trust balance<=limit,
    positive offer amount/price."""

    name = "LedgerEntryIsValid"

    def check(self, ctx: InvariantContext) -> Optional[str]:
        seq = ctx.header.ledgerSeq
        stamped = ctx.delta.update_last_modified
        for key, entry, _created in ctx.sample(ctx.changed_entries()):
            lm = entry.lastModifiedLedgerSeq
            if (stamped and lm != seq) or lm > seq:
                return (
                    f"{key.type.name} entry lastModified {lm} != "
                    f"closing ledgerSeq {seq}"
                )
            msg = self._check_entry(key, entry)
            if msg is not None:
                return msg
        return None

    def _check_entry(self, key, entry) -> Optional[str]:
        ty = entry.data.type
        d = entry.data.value
        if ty != key.type:
            return f"entry type {ty} under a {key.type} key"
        if ty == LedgerEntryType.ACCOUNT:
            aid = _aid(d.accountID)[:8]
            if not (0 <= d.balance <= INT64_MAX):
                return f"account {aid}..: balance {d.balance} out of range"
            if d.seqNum < 0:
                return f"account {aid}..: negative seqNum {d.seqNum}"
            if d.numSubEntries < 0:
                return f"account {aid}..: negative numSubEntries"
            if len(d.thresholds) != 4:
                return (
                    f"account {aid}..: thresholds is "
                    f"{len(d.thresholds)} byte(s), not 4"
                )
            if len(d.signers) > 20:
                return f"account {aid}..: {len(d.signers)} signers (>20)"
            for s in d.signers:
                if not (1 <= s.weight <= 255):
                    return f"account {aid}..: signer weight {s.weight}"
            raw = [s.pubKey.value for s in d.signers]
            if raw != sorted(raw) or len(set(raw)) != len(raw):
                return f"account {aid}..: signers not in canonical order"
        elif ty == LedgerEntryType.TRUSTLINE:
            aid = _aid(d.accountID)[:8]
            if d.asset.is_native():
                return f"trustline {aid}..: native asset"
            if not (0 < d.limit <= INT64_MAX):
                return f"trustline {aid}..: limit {d.limit} out of range"
            if not (0 <= d.balance <= d.limit):
                return (
                    f"trustline {aid}..: balance {d.balance} outside "
                    f"[0, limit {d.limit}]"
                )
        elif ty == LedgerEntryType.OFFER:
            if d.offerID <= 0:
                return f"offer: non-positive offerID {d.offerID}"
            if not (0 < d.amount <= INT64_MAX):
                return f"offer {d.offerID}: amount {d.amount} out of range"
            if d.price.n <= 0 or d.price.d <= 0:
                return (
                    f"offer {d.offerID}: non-positive price "
                    f"{d.price.n}/{d.price.d}"
                )
        return None


class CacheIsConsistentWithDatabase(Invariant):
    """The decoded-entry cache and the flushed SQL rows agree with the
    delta for (a sample of) the entries this close changed
    (CacheIsConsistentWithDatabase.cpp) — the direct guard on the
    FrameContext identity map and the store buffer: an aliasing bug that
    stored through a stale frame, or a flush that dropped a row, shows up
    as one of these three planes disagreeing."""

    name = "CacheIsConsistentWithDatabase"

    def check(self, ctx: InvariantContext) -> Optional[str]:
        from ..ledger.entryframe import key_bytes

        cache = getattr(ctx.db, "_entry_cache", None)
        for key, entry, _created in ctx.sample(ctx.changed_entries()):
            kb = key_bytes(key)
            want = entry.to_xdr()
            if cache is not None:
                hit, cached = cache.peek(kb)
                if hit and (cached is None or cached.to_xdr() != want):
                    return (
                        f"entry cache disagrees with the delta for changed "
                        f"{key.type.name} key "
                        f"({'known-absent' if cached is None else 'stale value'})"
                    )
            frame = _load_fresh(ctx.db, key)
            if frame is None:
                return f"changed {key.type.name} entry missing from SQL"
            if frame.entry.to_xdr() != want:
                return (
                    f"SQL row disagrees with the delta for changed "
                    f"{key.type.name} key"
                )
        for key in ctx.sample(list(ctx.delta.iter_deleted())):
            kb = key_bytes(key)
            if cache is not None:
                hit, cached = cache.peek(kb)
                if hit and cached is not None:
                    return (
                        f"entry cache still holds deleted {key.type.name} key"
                    )
            if _load_fresh(ctx.db, key) is not None:
                return f"deleted {key.type.name} entry still present in SQL"
        return None


#: Registration order == execution order (cheap exact header checks first).
ALL_INVARIANTS = {
    cls.name: cls
    for cls in (
        ConservationOfLumens,
        AccountSubEntriesCountIsValid,
        LedgerEntryIsValid,
        CacheIsConsistentWithDatabase,
    )
}


def resolve_invariants(names) -> List[Invariant]:
    """Instantiate the configured invariant set.  ``["all"]`` (the
    default) enables every registered invariant; ``[]`` disables the
    plane; unknown names raise (a typo must not silently disable a
    safety check)."""
    if names is None:
        names = ["all"]
    out, seen = [], set()
    for n in names:
        expanded = list(ALL_INVARIANTS) if n == "all" else [n]
        for name in expanded:
            if name not in ALL_INVARIANTS:
                raise ValueError(
                    f"unknown invariant {name!r} "
                    f"(known: {', '.join(ALL_INVARIANTS)} or 'all')"
                )
            if name not in seen:
                seen.add(name)
                out.append(ALL_INVARIANTS[name]())
    return out
