"""txhistory / txfeehistory tables (reference: TransactionFrame::storeTransaction
/ storeTransactionFee, src/transactions/TransactionFrame.cpp:497-560).

Rows keep base64 XDR blobs of the envelope, result pair, and meta — the
publish state machine reads them back out to build history checkpoint files.
"""

from __future__ import annotations

import base64
from typing import List, Optional, Tuple

from ..xdr.ledger import (
    LEDGER_ENTRY_CHANGES,
    TransactionHistoryEntry,
    TransactionHistoryResultEntry,
    TransactionMeta,
    TransactionResultPair,
)
from ..xdr.txs import TransactionEnvelope


def drop_tx_history(db) -> None:
    db.execute("DROP TABLE IF EXISTS txhistory")
    db.execute("DROP TABLE IF EXISTS txfeehistory")
    db.execute(
        """CREATE TABLE txhistory (
            txid      CHARACTER(64) NOT NULL,
            ledgerseq INT NOT NULL CHECK (ledgerseq >= 0),
            txindex   INT NOT NULL,
            txbody    TEXT NOT NULL,
            txresult  TEXT NOT NULL,
            txmeta    TEXT NOT NULL,
            PRIMARY KEY (txid, ledgerseq)
        )"""
    )
    db.execute("CREATE INDEX histbyseq ON txhistory (ledgerseq)")
    db.execute(
        """CREATE TABLE txfeehistory (
            txid      CHARACTER(64) NOT NULL,
            ledgerseq INT NOT NULL CHECK (ledgerseq >= 0),
            txindex   INT NOT NULL,
            txchanges TEXT NOT NULL,
            PRIMARY KEY (txid, ledgerseq)
        )"""
    )
    db.execute("CREATE INDEX histfeebyseq ON txfeehistory (ledgerseq)")


def transaction_row(
    tx_id: bytes,
    ledger_seq: int,
    tx_index: int,
    envelope_xdr: bytes,
    result_pair: TransactionResultPair,
    meta: TransactionMeta,
) -> Tuple:
    return (
        tx_id.hex(),
        ledger_seq,
        tx_index,
        base64.b64encode(envelope_xdr).decode(),
        base64.b64encode(result_pair.to_xdr()).decode(),
        base64.b64encode(meta.to_xdr()).decode(),
    )


def fee_row(tx_id: bytes, ledger_seq: int, tx_index: int, changes) -> Tuple:
    return (
        tx_id.hex(),
        ledger_seq,
        tx_index,
        base64.b64encode(LEDGER_ENTRY_CHANGES.pack(changes)).decode(),
    )


_TX_INSERT = (
    "INSERT INTO txhistory (txid, ledgerseq, txindex, txbody, txresult, txmeta)"
    " VALUES (?,?,?,?,?,?)"
)
_FEE_INSERT = (
    "INSERT INTO txfeehistory (txid, ledgerseq, txindex, txchanges)"
    " VALUES (?,?,?,?)"
)


def insert_transaction_rows(db, rows: List[Tuple]) -> None:
    """Bulk path for ledger close: one executemany for the whole txset."""
    if rows:
        db.executemany(_TX_INSERT, rows)


def insert_fee_rows(db, rows: List[Tuple]) -> None:
    if rows:
        db.executemany(_FEE_INSERT, rows)


def load_transaction_history(db, ledger_seq: int) -> List[Tuple]:
    """[(envelope, result_pair)] in apply (txindex) order."""
    rows = db.query_all(
        "SELECT txbody, txresult FROM txhistory WHERE ledgerseq=? ORDER BY txindex",
        (ledger_seq,),
    )
    return [
        (
            TransactionEnvelope.from_xdr(base64.b64decode(b)),
            TransactionResultPair.from_xdr(base64.b64decode(r)),
        )
        for b, r in rows
    ]


def delete_old_entries(db, ledger_seq: int) -> None:
    db.execute("DELETE FROM txhistory WHERE ledgerseq <= ?", (ledger_seq,))
    db.execute("DELETE FROM txfeehistory WHERE ledgerseq <= ?", (ledger_seq,))
