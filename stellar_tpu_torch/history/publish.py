"""Crash-safe publish queue table (reference: HistoryManagerImpl.cpp:48-53,
publishqueue; snapshots queue inside the ledger-close SQL transaction at
LedgerManagerImpl.cpp:710-736 so a crash never loses a checkpoint).
"""

from __future__ import annotations

from typing import List

from ..util import fs

# the queue row is written INSIDE the ledger-close transaction; a kill
# here must repair to "checkpoint still queued" (or "close never
# happened") on restart — never to a lost checkpoint
KP_QUEUE_ROW = fs.register_kill_point(
    "publish.queue-row", "crash-safe publishqueue row written in the close txn"
)


def drop_publish_queue(db) -> None:
    db.execute("DROP TABLE IF EXISTS publishqueue")
    db.execute(
        """CREATE TABLE publishqueue (
            ledger   INTEGER PRIMARY KEY,
            state    TEXT
        )"""
    )


def queue_checkpoint(db, ledger_seq: int, state_json: str) -> None:
    db.execute(
        "INSERT OR REPLACE INTO publishqueue (ledger, state) VALUES (?,?)",
        (ledger_seq, state_json),
    )
    fs.kill_point(KP_QUEUE_ROW, ctx=db)


def queued_checkpoints(db) -> List[tuple]:
    return db.query_all("SELECT ledger, state FROM publishqueue ORDER BY ledger")


def min_queued(db) -> int:
    """Smallest queued checkpoint ledger, 0 if none (avoids pulling the
    archive-state blobs just to read a number)."""
    row = db.query_one("SELECT MIN(ledger) FROM publishqueue")
    return row[0] if row and row[0] is not None else 0


def dequeue_checkpoint(db, ledger_seq: int) -> None:
    db.execute("DELETE FROM publishqueue WHERE ledger=?", (ledger_seq,))
