"""Close-scoped frame identity map.

The reference loads an ``AccountFrame`` from the DB every time any part of
the close touches an account (``TransactionFrame::loadAccount``,
src/transactions/TransactionFrame.cpp): fee charging, validity at apply,
and every op each pay a fresh load.  Our decoded-entry cache made those
loads cheap-ish, but each mutable load still pays a defensive ``xdr_copy``
(~2.4 µs/account) plus frame construction — close profiles bill
AccountFrame load+init at ~0.5 s per 5000-tx close, 5-6 loads/tx.

``FrameContext`` hands out ONE ``AccountFrame`` per SIGNING account per
close: the first mutable tx-source load copies out of the cache as before
and ADOPTS the frame; every later signing load of that account — fee
charging, then validity at apply — returns the same object with no copy
(ops whose source IS the tx source reach that same frame too, via
``TransactionFrame.load_account_shared`` returning ``signing_account``,
exactly how the reference shares mSigningAccount).  The map serves ONLY the signing-account
plane (``TransactionFrame.load_account`` passes ``signing=True``): that is
exactly the aliasing the reference has (ONE shared mSigningAccount per tx,
fresh snapshots for everything else), so destination/winner/merge-target
loads keep taking fresh copies of last-stored state — aliasing those too
measurably diverges (a self path-payment's destination credit must NOT be
visible through the op's stale source handle; the reference loses the
interleave exactly the way a fresh snapshot does).  Correctness is carried
by three rules:

- **Stored state is canonical.**  Every mutation flow ends in
  ``store_add/store_change`` (``EntryFrame._record`` snapshots into the
  delta/cache/buffer as before), so a context frame's state between stores
  always equals "last stored snapshot + the in-flight mutation of the one
  linear apply path" — exactly what a reference re-load would observe.
- **Savepoints unwind the map.**  ``Database.transaction`` drives
  ``push_mark``/``rollback_mark``/``release_mark`` in lockstep with the SQL
  savepoints and the entry store buffer's marks: a rolled-back tx EVICTS
  every frame it was lent or stored (the frame may hold aborted mutations),
  so the next load re-reads the rolled-back cache/buffer/SQL planes.
  Eviction, never restoration — a previously-mapped frame object may itself
  have been mutated inside the aborted scope.
- **The readonly/owned discipline survives.**  A ``readonly=True`` load
  that hits the context returns a fresh frame SHELL sharing the context
  frame's live entry with ``_readonly`` set, so the existing
  ``EntryFrame.store_*`` refusal machinery keeps validation paths from
  storing (and the shell never becomes the working copy).  Context-owned
  frames additionally refuse stores once their context deactivates — a
  frame retained past its close cannot silently write stale state into a
  later ledger.

Seal-on-store CoW composes with the map: a store seals the
context frame (its entry becomes the shared delta/cache/buffer snapshot,
EntryFrame.touch), and ``lend`` un-seals on the next MUTABLE hand-out —
the one copy the old eager scheme paid per store is paid at most once
per re-borrow, and accounts whose last touch is a store never pay it.

The map is account-only (the profile's hot class; trust/offer loads are
comparatively rare) and lives on the ``Database`` object next to the entry
cache and store buffer, activated by ``LedgerManager.close_ledger``.
Equivalence with context-off is pinned by tests/test_framecontext.py
(identical ledger hashes, SQL dumps, and tx/fee history rows incl. metas,
PARANOID_MODE on both sides).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class FrameContext:
    def __init__(self):
        self.active = False
        # bumped per activation: a frame lent by close N is stale in close
        # N+1 even though the (reused) context object is active again —
        # the generation stamp lets _assert_mutable refuse it
        self.generation = 0
        self._map: Dict[bytes, object] = {}
        # undo log of key-bytes lent-or-stored since each mark; marks are
        # indices into it, one per live SQL savepoint (same shape as
        # EntryStoreBuffer's undo plane)
        self._touched: List[bytes] = []
        self._marks: List[int] = []
        self.hits = 0
        self.misses = 0

    # -- lifecycle (LedgerManager.close_ledger) ----------------------------
    def activate(self) -> None:
        assert not self.active and not self._map and not self._marks
        self.generation += 1
        self.active = True

    def deactivate(self) -> None:
        """Drop the map.  On the success path every frame's state was
        stored (cache/SQL agree); on an exception the enclosing close is
        rolling back and close_ledger clears the entry cache wholesale.
        Frames already handed out keep their ``_ctx`` reference, so a
        late store through one refuses (see EntryFrame._assert_mutable)."""
        self.active = False
        self._map.clear()
        self._touched.clear()
        self._marks.clear()

    # -- hand-out (AccountFrame.load_account) ------------------------------
    def _note(self, kb: bytes) -> None:
        """Log `kb` in the undo plane (callers ensure a mark is open).
        Dedup ONLY against an entry made inside the CURRENT innermost
        scope — a frame re-lent/re-stored inside a nested savepoint must
        be logged there too, or the inner rollback fails to evict it."""
        t = self._touched
        if t and t[-1] == kb and len(t) > self._marks[-1]:
            return
        t.append(kb)

    def lend(self, kb: bytes, mutable: bool):
        """The context frame for `kb`, or None.  Mutable hand-outs inside a
        savepoint are logged so a rollback evicts them (the borrower may
        mutate the frame before the scope dies).

        A SEALED frame (its entry is the shared post-store snapshot in
        the delta/cache/store-buffer — see EntryFrame.touch) is CoW-
        unsealed before a mutable hand-out: borrowers mutate through raw
        entry fields (``f.account.balance -= fee``), so handing a sealed
        frame out mutable would let those writes reach the shared
        snapshot and silently rewrite recorded history metas."""
        f = self._map.get(kb)
        if f is None:
            self.misses += 1
            return None
        self.hits += 1
        if mutable:
            if getattr(f, "_sealed", False):
                f.touch()
            if self._marks:
                self._note(kb)
        return f

    def adopt(self, kb: bytes, frame) -> None:
        """Make `frame` (owned: freshly copied or built) the canonical
        working frame for `kb`."""
        frame._ctx = self
        frame._ctx_gen = self.generation
        self._map[kb] = frame
        if self._marks:
            self._note(kb)

    def record_store(self, kb: bytes, frame) -> None:
        """A store went through `frame`: it becomes (or stays) canonical.
        Converging on the storing frame closes the identity-split hazard —
        a non-signing load (payment destination, inflation winner) or a
        built-from-scratch frame (create_account, bucket apply) that
        stored would otherwise leave a stale mapped frame behind."""
        if self._map.get(kb) is not frame:
            self.adopt(kb, frame)
        elif self._marks:
            self._note(kb)

    def evict(self, kb: bytes) -> None:
        """Entry deleted (store_delete): later loads must consult the
        cache/buffer/SQL planes, which now carry the deletion."""
        f = self._map.pop(kb, None)
        if f is not None:
            f._ctx = None

    # -- savepoint integration (Database.transaction) ----------------------
    def push_mark(self) -> None:
        self._marks.append(len(self._touched))

    def release_mark(self) -> None:
        self._marks.pop()
        if not self._marks:
            # nothing outer can roll back to before this point any more
            self._touched.clear()

    def rollback_mark(self) -> None:
        """Evict every frame lent or stored inside the rolled-back scope.
        The cache (delta rollback erased its lines), the store buffer
        (rolled back its own marks), and SQL (savepoint) all hold the
        pre-scope state, so the next load rebuilds a clean frame."""
        m = self._marks.pop()
        t = self._touched
        while len(t) > m:
            kb = t.pop()
            f = self._map.pop(kb, None)
            if f is not None:
                # orphaned: behaves like a plain owned frame again (its
                # holder is the aborted tx, which is done with it)
                f._ctx = None


def frame_context_of(db) -> FrameContext:
    ctx = getattr(db, "_frame_context", None)
    if ctx is None:
        ctx = FrameContext()
        db._frame_context = ctx
    return ctx


def active_frame_context(db) -> Optional[FrameContext]:
    ctx = getattr(db, "_frame_context", None)
    return ctx if ctx is not None and ctx.active else None
