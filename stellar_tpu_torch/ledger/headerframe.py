"""LedgerHeaderFrame: ledgerheaders table (reference: src/ledger/LedgerHeaderFrame.*).

Header hash = SHA256(xdr(header)).  The skipList is maintained by the
bucket manager at close: BucketManager.calculate_skip_values rotates
skipList[0..3] at SKIP_1/2/3/4 ledger boundaries, mirroring the reference
(src/bucket/BucketManagerImpl.cpp:308-331) for header-hash parity.
"""

from __future__ import annotations

import base64
from typing import Optional

from ..crypto import sha256
from ..xdr.ledger import LedgerHeader


class LedgerHeaderFrame:
    def __init__(self, header: LedgerHeader):
        self.header = header
        self._hash: Optional[bytes] = None

    @classmethod
    def from_previous(cls, prev: "LedgerHeaderFrame") -> "LedgerHeaderFrame":
        """Next-ledger template (LedgerHeaderFrame ctor from previous)."""
        from ..xdr.base import xdr_copy

        h = xdr_copy(prev.header)
        h.previousLedgerHash = prev.get_hash()
        h.ledgerSeq = prev.header.ledgerSeq + 1
        return cls(h)

    def get_hash(self) -> bytes:
        if self._hash is None:
            self._hash = sha256(self.header.to_xdr())
        return self._hash

    def invalidate_hash(self) -> None:
        self._hash = None

    def generate_id(self) -> int:
        self.header.idPool += 1
        return self.header.idPool

    # -- SQL ---------------------------------------------------------------
    @staticmethod
    def drop_all(db) -> None:
        db.execute("DROP TABLE IF EXISTS ledgerheaders")
        db.execute(
            """CREATE TABLE ledgerheaders (
                ledgerhash     CHARACTER(64) PRIMARY KEY,
                prevhash       CHARACTER(64) NOT NULL,
                bucketlisthash CHARACTER(64) NOT NULL,
                ledgerseq      INT UNIQUE CHECK (ledgerseq >= 0),
                closetime      BIGINT NOT NULL CHECK (closetime >= 0),
                data           TEXT NOT NULL
            )"""
        )
        db.execute("CREATE INDEX ledgersbyseq ON ledgerheaders (ledgerseq)")

    def store_insert(self, db) -> None:
        h = self.header
        with db.timed("insert", "ledger-header"):
            db.execute(
                """INSERT INTO ledgerheaders
                   (ledgerhash, prevhash, bucketlisthash, ledgerseq, closetime, data)
                   VALUES (?,?,?,?,?,?)""",
                (
                    self.get_hash().hex(),
                    h.previousLedgerHash.hex(),
                    h.bucketListHash.hex(),
                    h.ledgerSeq,
                    h.scpValue.closeTime,
                    base64.b64encode(h.to_xdr()).decode(),
                ),
            )

    @classmethod
    def _decode(cls, data: str) -> "LedgerHeaderFrame":
        return cls(LedgerHeader.from_xdr(base64.b64decode(data)))

    @classmethod
    def load_by_hash(cls, db, ledger_hash: bytes) -> Optional["LedgerHeaderFrame"]:
        row = db.query_one(
            "SELECT data FROM ledgerheaders WHERE ledgerhash=?", (ledger_hash.hex(),)
        )
        return cls._decode(row[0]) if row else None

    @classmethod
    def load_by_sequence(cls, db, seq: int) -> Optional["LedgerHeaderFrame"]:
        row = db.query_one(
            "SELECT data FROM ledgerheaders WHERE ledgerseq=?", (seq,)
        )
        return cls._decode(row[0]) if row else None

    @classmethod
    def load_range(cls, db, first: int, last: int):
        rows = db.query_all(
            "SELECT data FROM ledgerheaders WHERE ledgerseq>=? AND ledgerseq<=?"
            " ORDER BY ledgerseq",
            (first, last),
        )
        return [cls._decode(r[0]) for r in rows]

    @staticmethod
    def delete_old_entries(db, ledger_seq: int) -> None:
        db.execute("DELETE FROM ledgerheaders WHERE ledgerseq <= ?", (ledger_seq,))
