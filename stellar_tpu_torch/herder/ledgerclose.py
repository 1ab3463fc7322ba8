"""LedgerCloseData (reference: src/herder/LedgerCloseData.h):
the (ledgerSeq, TxSet, StellarValue) bundle consensus hands to the ledger."""

from __future__ import annotations

from dataclasses import dataclass

from ..xdr.ledger import StellarValue
from .txset import TxSetFrame


@dataclass
class LedgerCloseData:
    ledger_seq: int
    tx_set: TxSetFrame
    value: StellarValue
