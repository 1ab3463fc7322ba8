"""Herder — consensus glue layer (reference: src/herder/, ~3.6 kLoC)."""

from .herder import (
    CONSENSUS_STUCK_TIMEOUT_SECONDS,
    EXP_LEDGER_TIMESPAN_SECONDS,
    HERDER_SYNCING_STATE,
    HERDER_TRACKING_STATE,
    LEDGER_VALIDITY_BRACKET,
    MAX_TIME_SLIP_SECONDS,
    TX_STATUS_DUPLICATE,
    TX_STATUS_ERROR,
    TX_STATUS_PENDING,
    Herder,
)
from .ledgerclose import LedgerCloseData
from .pendingenvelopes import PendingEnvelopes
from .txset import TxSetFrame

__all__ = [
    "Herder",
    "LedgerCloseData",
    "PendingEnvelopes",
    "TxSetFrame",
    "TX_STATUS_PENDING",
    "TX_STATUS_DUPLICATE",
    "TX_STATUS_ERROR",
    "EXP_LEDGER_TIMESPAN_SECONDS",
    "CONSENSUS_STUCK_TIMEOUT_SECONDS",
    "MAX_TIME_SLIP_SECONDS",
    "LEDGER_VALIDITY_BRACKET",
    "HERDER_SYNCING_STATE",
    "HERDER_TRACKING_STATE",
]
