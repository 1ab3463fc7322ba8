"""Wire types from the reference's src/xdr/Stellar-ledger-entries.x (226 lines)."""

from __future__ import annotations

import enum
from typing import List, Optional

from .base import (
    array,
    int32,
    int64,
    opaque,
    option,
    string,
    uint32,
    uint64,
    var_array,
    xenum,
    xf,
    xstruct,
    xunion,
)
from .xtypes import PUBLIC_KEY, PublicKey

ACCOUNT_ID = PUBLIC_KEY  # typedef PublicKey AccountID
AccountID = PublicKey
THRESHOLDS = opaque(4)
STRING32 = string(32)
SEQUENCE_NUMBER = uint64


class AssetType(enum.IntEnum):
    ASSET_TYPE_NATIVE = 0
    ASSET_TYPE_CREDIT_ALPHANUM4 = 1
    ASSET_TYPE_CREDIT_ALPHANUM12 = 2


@xstruct
class AssetAlphaNum4:
    XDR_VALUE_SEMANTICS = True

    assetCode: bytes = xf(opaque(4))  # 1 to 4 characters
    issuer: PublicKey = xf(ACCOUNT_ID)


@xstruct
class AssetAlphaNum12:
    XDR_VALUE_SEMANTICS = True

    assetCode: bytes = xf(opaque(12))  # 5 to 12 characters
    issuer: PublicKey = xf(ACCOUNT_ID)


@xunion(
    xenum(AssetType),
    {
        AssetType.ASSET_TYPE_NATIVE: None,
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AssetAlphaNum4._codec),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AssetAlphaNum12._codec),
    },
)
class Asset:
    type: AssetType
    value: object = None

    @classmethod
    def native(cls) -> "Asset":
        return cls(AssetType.ASSET_TYPE_NATIVE, None)

    @classmethod
    def alphanum4(cls, code: bytes, issuer: PublicKey) -> "Asset":
        return cls(
            AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
            AssetAlphaNum4(code.ljust(4, b"\x00"), issuer),
        )

    @classmethod
    def alphanum12(cls, code: bytes, issuer: PublicKey) -> "Asset":
        return cls(
            AssetType.ASSET_TYPE_CREDIT_ALPHANUM12,
            AssetAlphaNum12(code.ljust(12, b"\x00"), issuer),
        )

    def is_native(self) -> bool:
        return self.type == AssetType.ASSET_TYPE_NATIVE

    def code_and_issuer(self):
        if self.type == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            return self.value.assetCode, self.value.issuer
        if self.type == AssetType.ASSET_TYPE_CREDIT_ALPHANUM12:
            return self.value.assetCode, self.value.issuer
        return None, None

    def __hash__(self):
        code, issuer = self.code_and_issuer()
        return hash((int(self.type), code, issuer.value if issuer else None))


ASSET = Asset._codec


@xstruct
class Price:
    XDR_VALUE_SEMANTICS = True

    n: int = xf(int32, 0)  # numerator
    d: int = xf(int32, 1)  # denominator


class ThresholdIndexes(enum.IntEnum):
    THRESHOLD_MASTER_WEIGHT = 0
    THRESHOLD_LOW = 1
    THRESHOLD_MED = 2
    THRESHOLD_HIGH = 3


class LedgerEntryType(enum.IntEnum):
    ACCOUNT = 0
    TRUSTLINE = 1
    OFFER = 2


@xstruct
class Signer:
    pubKey: PublicKey = xf(ACCOUNT_ID)
    weight: int = xf(uint32, 0)


class AccountFlags(enum.IntFlag):
    AUTH_REQUIRED_FLAG = 0x1
    AUTH_REVOCABLE_FLAG = 0x2
    AUTH_IMMUTABLE_FLAG = 0x4


MASK_ACCOUNT_FLAGS = 0x7


class _Ext0Codec(int32.__class__):
    """The ubiquitous reserved `union switch (int v) { case 0: void; } ext`."""

    def pack_into(self, val, out):
        # reserved arm: always writes 0 regardless of the field value, so a
        # stray in-memory value can never produce undecodable bytes
        super().pack_into(0, out)

    def unpack_from(self, buf, off):
        v, off = super().unpack_from(buf, off)
        if v != 0:
            from .base import XdrError

            raise XdrError(f"reserved ext union has v={v}")
        return 0, off


EXT0 = _Ext0Codec()


@xstruct
class AccountEntry:
    accountID: PublicKey = xf(ACCOUNT_ID)
    balance: int = xf(int64, 0)  # in stroops
    seqNum: int = xf(SEQUENCE_NUMBER, 0)
    numSubEntries: int = xf(uint32, 0)
    inflationDest: Optional[PublicKey] = xf(option(ACCOUNT_ID), None)
    flags: int = xf(uint32, 0)
    homeDomain: str = xf(STRING32, "")
    thresholds: bytes = xf(THRESHOLDS, b"\x01\x00\x00\x00")
    signers: List[Signer] = xf(var_array(Signer._codec, 20), factory=list)
    ext: int = xf(EXT0, 0)


class TrustLineFlags(enum.IntFlag):
    AUTHORIZED_FLAG = 1


MASK_TRUSTLINE_FLAGS = 1


@xstruct
class TrustLineEntry:
    accountID: PublicKey = xf(ACCOUNT_ID)
    asset: Asset = xf(ASSET)
    balance: int = xf(int64, 0)
    limit: int = xf(int64, 0)
    flags: int = xf(uint32, 0)
    ext: int = xf(EXT0, 0)


class OfferEntryFlags(enum.IntFlag):
    PASSIVE_FLAG = 1


@xstruct
class OfferEntry:
    sellerID: PublicKey = xf(ACCOUNT_ID)
    offerID: int = xf(uint64, 0)
    selling: Asset = xf(ASSET)  # A
    buying: Asset = xf(ASSET)  # B
    amount: int = xf(int64, 0)  # amount of A
    price: Price = xf(Price._codec, factory=Price)  # price of A in terms of B
    flags: int = xf(uint32, 0)
    ext: int = xf(EXT0, 0)


@xunion(
    xenum(LedgerEntryType),
    {
        LedgerEntryType.ACCOUNT: ("account", AccountEntry._codec),
        LedgerEntryType.TRUSTLINE: ("trustLine", TrustLineEntry._codec),
        LedgerEntryType.OFFER: ("offer", OfferEntry._codec),
    },
)
class LedgerEntryData:
    type: LedgerEntryType
    value: object = None


@xstruct
class LedgerEntry:
    lastModifiedLedgerSeq: int = xf(uint32, 0)
    data: LedgerEntryData = xf(LedgerEntryData._codec)
    ext: int = xf(EXT0, 0)


class EnvelopeType(enum.IntEnum):
    ENVELOPE_TYPE_SCP = 1
    ENVELOPE_TYPE_TX = 2
    ENVELOPE_TYPE_AUTH = 3
