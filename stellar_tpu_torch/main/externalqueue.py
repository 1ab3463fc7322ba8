"""ExternalQueue: pubsub cursors gating maintenance deletion
(reference: src/main/ExternalQueue.*).

External consumers (a Horizon-alike) register a cursor; ``maintenance``
(``process``) trims ledger headers AND tx history at/below the lesser of
the minimum cursor and what history publishing still needs (one full
checkpoint before the publish point), via LedgerManager.delete_old_entries.
"""

from __future__ import annotations

import re
from typing import Optional


class ExternalQueue:
    _VALID = re.compile(r"^[A-Z][A-Z0-9]{0,31}$")

    def __init__(self, app_or_db):
        self._app = app_or_db if hasattr(app_or_db, "database") else None
        self._db = getattr(app_or_db, "database", app_or_db)

    @staticmethod
    def drop_all(db) -> None:
        db.execute("DROP TABLE IF EXISTS pubsub")
        db.execute(
            """CREATE TABLE pubsub (
                resid    CHARACTER(32) PRIMARY KEY,
                lastread INTEGER
            )"""
        )

    @classmethod
    def validate_resource_id(cls, resid: str) -> bool:
        return bool(cls._VALID.match(resid))

    def set_cursor_for_resource(self, resid: str, cursor: int) -> None:
        if not self.validate_resource_id(resid):
            raise ValueError(f"invalid resource id {resid!r}")
        self._db.execute(
            "INSERT INTO pubsub (resid, lastread) VALUES (?,?) "
            "ON CONFLICT(resid) DO UPDATE SET lastread=excluded.lastread",
            (resid, cursor),
        )

    def get_cursor_for_resource(self, resid: str) -> Optional[int]:
        row = self._db.query_one(
            "SELECT lastread FROM pubsub WHERE resid=?", (resid,)
        )
        return row[0] if row else None

    def delete_cursor(self, resid: str) -> None:
        self._db.execute("DELETE FROM pubsub WHERE resid=?", (resid,))

    def min_cursor(self) -> Optional[int]:
        row = self._db.query_one("SELECT MIN(lastread) FROM pubsub")
        return row[0] if row and row[0] is not None else None

    def process(self, count: int = 50000) -> int:
        """Trim ledger headers + tx history at/below cmin, the lesser of
        what remote subscribers still need (min cursor; maxint with no
        subscribers) and what history publishing still needs — one full
        checkpoint before min(queued-to-publish, LCL).  Work per call is
        bounded: at most ``count`` ledgers past the oldest retained one
        are trimmed, so a huge backlog drains over repeated maintenance
        calls instead of one blocking DELETE.  Returns the effective
        trim point.  (reference: ExternalQueue::process,
        ExternalQueue.cpp:98-144.)"""
        from ..ledger.manager import LedgerManager

        app = self._app
        if app is None:
            raise RuntimeError("process() needs an ExternalQueue(app)")
        rmin = self.min_cursor()
        rmin = 0xFFFFFFFF if rmin is None else rmin
        lcl = app.ledger_manager.get_last_closed_ledger_num()
        ql = app.history_manager.get_min_ledger_queued_to_publish()
        qmin = lcl if ql == 0 else min(ql, lcl)
        freq = app.history_manager.checkpoint_frequency
        lmin = qmin - freq if qmin >= freq else 0
        cmin = min(lmin, rmin)
        row = self._db.query_one("SELECT MIN(ledgerseq) FROM ledgerheaders")
        if row and row[0] is not None:
            cmin = min(cmin, row[0] + max(1, count) - 1)
        LedgerManager.delete_old_entries(self._db, cmin)
        return cmin
