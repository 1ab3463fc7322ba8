"""Wire types from the reference's src/xdr/Stellar-ledger.x (234 lines)."""

from __future__ import annotations

import enum
from typing import List

from .base import (
    array,
    int32,
    int64,
    uint32,
    uint64,
    var_array,
    var_opaque,
    xenum,
    xf,
    xstruct,
    xunion,
)
from .entries import (
    ACCOUNT_ID,
    ASSET,
    EXT0,
    Asset,
    LedgerEntry,
    LedgerEntryType,
    PublicKey,
)
from .txs import TransactionEnvelope, TransactionResult
from .xtypes import HASH

UPGRADE_TYPE = var_opaque(128)
MAX_TX_PER_LEDGER = 5000


@xstruct
class StellarValue:
    txSetHash: bytes = xf(HASH, b"\x00" * 32)
    closeTime: int = xf(uint64, 0)
    upgrades: List[bytes] = xf(var_array(UPGRADE_TYPE, 6), factory=list)
    ext: int = xf(EXT0, 0)


@xstruct
class LedgerHeader:
    ledgerVersion: int = xf(uint32, 0)
    previousLedgerHash: bytes = xf(HASH, b"\x00" * 32)
    scpValue: StellarValue = xf(StellarValue._codec, factory=StellarValue)
    txSetResultHash: bytes = xf(HASH, b"\x00" * 32)
    bucketListHash: bytes = xf(HASH, b"\x00" * 32)
    ledgerSeq: int = xf(uint32, 0)
    totalCoins: int = xf(int64, 0)
    feePool: int = xf(int64, 0)
    inflationSeq: int = xf(uint32, 0)
    idPool: int = xf(uint64, 0)
    baseFee: int = xf(uint32, 100)
    baseReserve: int = xf(uint32, 100000000)
    maxTxSetSize: int = xf(uint32, 100)
    skipList: List[bytes] = xf(array(HASH, 4), factory=lambda: [b"\x00" * 32] * 4)
    ext: int = xf(EXT0, 0)


class LedgerUpgradeType(enum.IntEnum):
    LEDGER_UPGRADE_VERSION = 1
    LEDGER_UPGRADE_BASE_FEE = 2
    LEDGER_UPGRADE_MAX_TX_SET_SIZE = 3


@xunion(
    xenum(LedgerUpgradeType),
    {
        LedgerUpgradeType.LEDGER_UPGRADE_VERSION: ("newLedgerVersion", uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: ("newBaseFee", uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE: (
            "newMaxTxSetSize",
            uint32,
        ),
    },
)
class LedgerUpgrade:
    type: LedgerUpgradeType
    value: object = None


@xstruct
class LedgerKeyAccount:
    accountID: PublicKey = xf(ACCOUNT_ID)


@xstruct
class LedgerKeyTrustLine:
    accountID: PublicKey = xf(ACCOUNT_ID)
    asset: Asset = xf(ASSET)


@xstruct
class LedgerKeyOffer:
    sellerID: PublicKey = xf(ACCOUNT_ID)
    offerID: int = xf(uint64, 0)


@xunion(
    xenum(LedgerEntryType),
    {
        LedgerEntryType.ACCOUNT: ("account", LedgerKeyAccount._codec),
        LedgerEntryType.TRUSTLINE: ("trustLine", LedgerKeyTrustLine._codec),
        LedgerEntryType.OFFER: ("offer", LedgerKeyOffer._codec),
    },
)
class LedgerKey:
    type: LedgerEntryType
    value: object = None

    def __hash__(self):
        return hash(self.to_xdr())


class BucketEntryType(enum.IntEnum):
    LIVEENTRY = 0
    DEADENTRY = 1


@xunion(
    xenum(BucketEntryType),
    {
        BucketEntryType.LIVEENTRY: ("liveEntry", LedgerEntry._codec),
        BucketEntryType.DEADENTRY: ("deadEntry", LedgerKey._codec),
    },
)
class BucketEntry:
    type: BucketEntryType
    value: object = None


@xstruct
class TransactionSet:
    previousLedgerHash: bytes = xf(HASH, b"\x00" * 32)
    txs: List[TransactionEnvelope] = xf(
        var_array(TransactionEnvelope._codec, MAX_TX_PER_LEDGER), factory=list
    )


@xstruct
class TransactionResultPair:
    transactionHash: bytes = xf(HASH, b"\x00" * 32)
    result: TransactionResult = xf(TransactionResult._codec, factory=TransactionResult)


@xstruct
class TransactionResultSet:
    results: List[TransactionResultPair] = xf(
        var_array(TransactionResultPair._codec, MAX_TX_PER_LEDGER), factory=list
    )


@xstruct
class TransactionHistoryEntry:
    ledgerSeq: int = xf(uint32, 0)
    txSet: TransactionSet = xf(TransactionSet._codec, factory=TransactionSet)
    ext: int = xf(EXT0, 0)


@xstruct
class TransactionHistoryResultEntry:
    ledgerSeq: int = xf(uint32, 0)
    txResultSet: TransactionResultSet = xf(
        TransactionResultSet._codec, factory=TransactionResultSet
    )
    ext: int = xf(EXT0, 0)


@xstruct
class LedgerHeaderHistoryEntry:
    hash: bytes = xf(HASH, b"\x00" * 32)
    header: LedgerHeader = xf(LedgerHeader._codec, factory=LedgerHeader)
    ext: int = xf(EXT0, 0)


class LedgerEntryChangeType(enum.IntEnum):
    LEDGER_ENTRY_CREATED = 0
    LEDGER_ENTRY_UPDATED = 1
    LEDGER_ENTRY_REMOVED = 2


@xunion(
    xenum(LedgerEntryChangeType),
    {
        LedgerEntryChangeType.LEDGER_ENTRY_CREATED: ("created", LedgerEntry._codec),
        LedgerEntryChangeType.LEDGER_ENTRY_UPDATED: ("updated", LedgerEntry._codec),
        LedgerEntryChangeType.LEDGER_ENTRY_REMOVED: ("removed", LedgerKey._codec),
    },
)
class LedgerEntryChange:
    type: LedgerEntryChangeType
    value: object = None


LEDGER_ENTRY_CHANGES = var_array(LedgerEntryChange._codec)


@xstruct
class OperationMeta:
    changes: List[LedgerEntryChange] = xf(LEDGER_ENTRY_CHANGES, factory=list)


@xunion(
    # `union TransactionMeta switch (int v) { case 0: OperationMeta operations<>; }`
    # — discriminant is a plain int, not an enum.
    int32,
    {0: ("operations", var_array(OperationMeta._codec))},
)
class TransactionMeta:
    type: int
    value: object = None
