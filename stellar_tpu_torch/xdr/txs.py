"""Wire types from the reference's src/xdr/Stellar-transaction.x (677 lines)."""

from __future__ import annotations

import enum
from typing import List, Optional

from .base import (
    int32,
    int64,
    opaque,
    option,
    string,
    uint32,
    uint64,
    var_array,
    xbool,
    xenum,
    xf,
    xstruct,
    xunion,
)
from .entries import (
    ACCOUNT_ID,
    ASSET,
    EXT0,
    SEQUENCE_NUMBER,
    STRING32,
    Asset,
    AssetType,
    OfferEntry,
    Price,
    PublicKey,
    Signer,
)
from .xtypes import HASH, SIGNATURE, SIGNATURE_HINT


@xstruct
class DecoratedSignature:
    hint: bytes = xf(SIGNATURE_HINT, b"\x00" * 4)  # last 4 bytes of pubkey
    signature: bytes = xf(SIGNATURE, b"")


class OperationType(enum.IntEnum):
    CREATE_ACCOUNT = 0
    PAYMENT = 1
    PATH_PAYMENT = 2
    MANAGE_OFFER = 3
    CREATE_PASSIVE_OFFER = 4
    SET_OPTIONS = 5
    CHANGE_TRUST = 6
    ALLOW_TRUST = 7
    ACCOUNT_MERGE = 8
    INFLATION = 9


@xstruct
class CreateAccountOp:
    destination: PublicKey = xf(ACCOUNT_ID)
    startingBalance: int = xf(int64, 0)


@xstruct
class PaymentOp:
    destination: PublicKey = xf(ACCOUNT_ID)
    asset: Asset = xf(ASSET)
    amount: int = xf(int64, 0)


@xstruct
class PathPaymentOp:
    sendAsset: Asset = xf(ASSET)
    sendMax: int = xf(int64, 0)
    destination: PublicKey = xf(ACCOUNT_ID)
    destAsset: Asset = xf(ASSET)
    destAmount: int = xf(int64, 0)
    path: List[Asset] = xf(var_array(ASSET, 5), factory=list)


@xstruct
class ManageOfferOp:
    selling: Asset = xf(ASSET)
    buying: Asset = xf(ASSET)
    amount: int = xf(int64, 0)  # 0 deletes the offer
    price: Price = xf(Price._codec, factory=Price)
    offerID: int = xf(uint64, 0)  # 0 creates a new offer


@xstruct
class CreatePassiveOfferOp:
    selling: Asset = xf(ASSET)  # A
    buying: Asset = xf(ASSET)  # B
    amount: int = xf(int64, 0)
    price: Price = xf(Price._codec, factory=Price)


@xstruct
class SetOptionsOp:
    inflationDest: Optional[PublicKey] = xf(option(ACCOUNT_ID), None)
    clearFlags: Optional[int] = xf(option(uint32), None)
    setFlags: Optional[int] = xf(option(uint32), None)
    masterWeight: Optional[int] = xf(option(uint32), None)
    lowThreshold: Optional[int] = xf(option(uint32), None)
    medThreshold: Optional[int] = xf(option(uint32), None)
    highThreshold: Optional[int] = xf(option(uint32), None)
    homeDomain: Optional[str] = xf(option(STRING32), None)
    signer: Optional[Signer] = xf(option(Signer._codec), None)


@xstruct
class ChangeTrustOp:
    line: Asset = xf(ASSET)
    limit: int = xf(int64, 0)  # 0 deletes the trust line


@xunion(
    xenum(AssetType),
    {
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("assetCode4", opaque(4)),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("assetCode12", opaque(12)),
    },
)
class AllowTrustAsset:
    type: AssetType
    value: object = None


@xstruct
class AllowTrustOp:
    trustor: PublicKey = xf(ACCOUNT_ID)
    asset: AllowTrustAsset = xf(AllowTrustAsset._codec)
    authorize: bool = xf(xbool, False)


@xunion(
    xenum(OperationType),
    {
        OperationType.CREATE_ACCOUNT: ("createAccountOp", CreateAccountOp._codec),
        OperationType.PAYMENT: ("paymentOp", PaymentOp._codec),
        OperationType.PATH_PAYMENT: ("pathPaymentOp", PathPaymentOp._codec),
        OperationType.MANAGE_OFFER: ("manageOfferOp", ManageOfferOp._codec),
        OperationType.CREATE_PASSIVE_OFFER: (
            "createPassiveOfferOp",
            CreatePassiveOfferOp._codec,
        ),
        OperationType.SET_OPTIONS: ("setOptionsOp", SetOptionsOp._codec),
        OperationType.CHANGE_TRUST: ("changeTrustOp", ChangeTrustOp._codec),
        OperationType.ALLOW_TRUST: ("allowTrustOp", AllowTrustOp._codec),
        OperationType.ACCOUNT_MERGE: ("destination", ACCOUNT_ID),
        OperationType.INFLATION: None,
    },
)
class OperationBody:
    type: OperationType
    value: object = None


@xstruct
class Operation:
    sourceAccount: Optional[PublicKey] = xf(option(ACCOUNT_ID), None)
    body: OperationBody = xf(OperationBody._codec)


class MemoType(enum.IntEnum):
    MEMO_NONE = 0
    MEMO_TEXT = 1
    MEMO_ID = 2
    MEMO_HASH = 3
    MEMO_RETURN = 4


@xunion(
    xenum(MemoType),
    {
        MemoType.MEMO_NONE: None,
        MemoType.MEMO_TEXT: ("text", string(28)),
        MemoType.MEMO_ID: ("id", uint64),
        MemoType.MEMO_HASH: ("hash", HASH),
        MemoType.MEMO_RETURN: ("retHash", HASH),
    },
)
class Memo:
    type: MemoType
    value: object = None

    @classmethod
    def none(cls) -> "Memo":
        return cls(MemoType.MEMO_NONE, None)


@xstruct
class TimeBounds:
    minTime: int = xf(uint64, 0)
    maxTime: int = xf(uint64, 0)


@xstruct
class Transaction:
    sourceAccount: PublicKey = xf(ACCOUNT_ID)
    fee: int = xf(uint32, 0)
    seqNum: int = xf(SEQUENCE_NUMBER, 0)
    timeBounds: Optional[TimeBounds] = xf(option(TimeBounds._codec), None)
    memo: Memo = xf(Memo._codec, factory=Memo.none)
    operations: List[Operation] = xf(var_array(Operation._codec, 100), factory=list)
    ext: int = xf(EXT0, 0)


@xstruct
class TransactionEnvelope:
    tx: Transaction = xf(Transaction._codec)
    signatures: List[DecoratedSignature] = xf(
        var_array(DecoratedSignature._codec, 20), factory=list
    )


# ---------------------------------------------------------------------------
# Operation results
# ---------------------------------------------------------------------------


@xstruct
class ClaimOfferAtom:
    sellerID: PublicKey = xf(ACCOUNT_ID)
    offerID: int = xf(uint64, 0)
    assetSold: Asset = xf(ASSET)
    amountSold: int = xf(int64, 0)
    assetBought: Asset = xf(ASSET)
    amountBought: int = xf(int64, 0)


class CreateAccountResultCode(enum.IntEnum):
    CREATE_ACCOUNT_SUCCESS = 0
    CREATE_ACCOUNT_MALFORMED = -1
    CREATE_ACCOUNT_UNDERFUNDED = -2
    CREATE_ACCOUNT_LOW_RESERVE = -3
    CREATE_ACCOUNT_ALREADY_EXIST = -4


@xunion(xenum(CreateAccountResultCode), {}, default_void=True)
class CreateAccountResult:
    type: CreateAccountResultCode
    value: object = None


class PaymentResultCode(enum.IntEnum):
    PAYMENT_SUCCESS = 0
    PAYMENT_MALFORMED = -1
    PAYMENT_UNDERFUNDED = -2
    PAYMENT_SRC_NO_TRUST = -3
    PAYMENT_SRC_NOT_AUTHORIZED = -4
    PAYMENT_NO_DESTINATION = -5
    PAYMENT_NO_TRUST = -6
    PAYMENT_NOT_AUTHORIZED = -7
    PAYMENT_LINE_FULL = -8
    PAYMENT_NO_ISSUER = -9


@xunion(xenum(PaymentResultCode), {}, default_void=True)
class PaymentResult:
    type: PaymentResultCode
    value: object = None


class PathPaymentResultCode(enum.IntEnum):
    PATH_PAYMENT_SUCCESS = 0
    PATH_PAYMENT_MALFORMED = -1
    PATH_PAYMENT_UNDERFUNDED = -2
    PATH_PAYMENT_SRC_NO_TRUST = -3
    PATH_PAYMENT_SRC_NOT_AUTHORIZED = -4
    PATH_PAYMENT_NO_DESTINATION = -5
    PATH_PAYMENT_NO_TRUST = -6
    PATH_PAYMENT_NOT_AUTHORIZED = -7
    PATH_PAYMENT_LINE_FULL = -8
    PATH_PAYMENT_NO_ISSUER = -9
    PATH_PAYMENT_TOO_FEW_OFFERS = -10
    PATH_PAYMENT_OFFER_CROSS_SELF = -11
    PATH_PAYMENT_OVER_SENDMAX = -12


@xstruct
class SimplePaymentResult:
    destination: PublicKey = xf(ACCOUNT_ID)
    asset: Asset = xf(ASSET)
    amount: int = xf(int64, 0)


@xstruct
class PathPaymentSuccess:
    offers: List[ClaimOfferAtom] = xf(var_array(ClaimOfferAtom._codec), factory=list)
    last: SimplePaymentResult = xf(SimplePaymentResult._codec)


@xunion(
    xenum(PathPaymentResultCode),
    {
        PathPaymentResultCode.PATH_PAYMENT_SUCCESS: (
            "success",
            PathPaymentSuccess._codec,
        ),
        PathPaymentResultCode.PATH_PAYMENT_NO_ISSUER: ("noIssuer", ASSET),
    },
    default_void=True,
)
class PathPaymentResult:
    type: PathPaymentResultCode
    value: object = None


class ManageOfferResultCode(enum.IntEnum):
    MANAGE_OFFER_SUCCESS = 0
    MANAGE_OFFER_MALFORMED = -1
    MANAGE_OFFER_SELL_NO_TRUST = -2
    MANAGE_OFFER_BUY_NO_TRUST = -3
    MANAGE_OFFER_SELL_NOT_AUTHORIZED = -4
    MANAGE_OFFER_BUY_NOT_AUTHORIZED = -5
    MANAGE_OFFER_LINE_FULL = -6
    MANAGE_OFFER_UNDERFUNDED = -7
    MANAGE_OFFER_CROSS_SELF = -8
    MANAGE_OFFER_SELL_NO_ISSUER = -9
    MANAGE_OFFER_BUY_NO_ISSUER = -10
    MANAGE_OFFER_NOT_FOUND = -11
    MANAGE_OFFER_LOW_RESERVE = -12


class ManageOfferEffect(enum.IntEnum):
    MANAGE_OFFER_CREATED = 0
    MANAGE_OFFER_UPDATED = 1
    MANAGE_OFFER_DELETED = 2


@xunion(
    xenum(ManageOfferEffect),
    {
        ManageOfferEffect.MANAGE_OFFER_CREATED: ("created", OfferEntry._codec),
        ManageOfferEffect.MANAGE_OFFER_UPDATED: ("updated", OfferEntry._codec),
    },
    default_void=True,
)
class ManageOfferSuccessResultOffer:
    type: ManageOfferEffect
    value: object = None


@xstruct
class ManageOfferSuccessResult:
    offersClaimed: List[ClaimOfferAtom] = xf(
        var_array(ClaimOfferAtom._codec), factory=list
    )
    offer: ManageOfferSuccessResultOffer = xf(
        ManageOfferSuccessResultOffer._codec,
        factory=lambda: ManageOfferSuccessResultOffer(
            ManageOfferEffect.MANAGE_OFFER_DELETED, None
        ),
    )


@xunion(
    xenum(ManageOfferResultCode),
    {
        ManageOfferResultCode.MANAGE_OFFER_SUCCESS: (
            "success",
            ManageOfferSuccessResult._codec,
        )
    },
    default_void=True,
)
class ManageOfferResult:
    type: ManageOfferResultCode
    value: object = None


class SetOptionsResultCode(enum.IntEnum):
    SET_OPTIONS_SUCCESS = 0
    SET_OPTIONS_LOW_RESERVE = -1
    SET_OPTIONS_TOO_MANY_SIGNERS = -2
    SET_OPTIONS_BAD_FLAGS = -3
    SET_OPTIONS_INVALID_INFLATION = -4
    SET_OPTIONS_CANT_CHANGE = -5
    SET_OPTIONS_UNKNOWN_FLAG = -6
    SET_OPTIONS_THRESHOLD_OUT_OF_RANGE = -7
    SET_OPTIONS_BAD_SIGNER = -8
    SET_OPTIONS_INVALID_HOME_DOMAIN = -9


@xunion(xenum(SetOptionsResultCode), {}, default_void=True)
class SetOptionsResult:
    type: SetOptionsResultCode
    value: object = None


class ChangeTrustResultCode(enum.IntEnum):
    CHANGE_TRUST_SUCCESS = 0
    CHANGE_TRUST_MALFORMED = -1
    CHANGE_TRUST_NO_ISSUER = -2
    CHANGE_TRUST_INVALID_LIMIT = -3
    CHANGE_TRUST_LOW_RESERVE = -4


@xunion(xenum(ChangeTrustResultCode), {}, default_void=True)
class ChangeTrustResult:
    type: ChangeTrustResultCode
    value: object = None


class AllowTrustResultCode(enum.IntEnum):
    ALLOW_TRUST_SUCCESS = 0
    ALLOW_TRUST_MALFORMED = -1
    ALLOW_TRUST_NO_TRUST_LINE = -2
    ALLOW_TRUST_TRUST_NOT_REQUIRED = -3
    ALLOW_TRUST_CANT_REVOKE = -4


@xunion(xenum(AllowTrustResultCode), {}, default_void=True)
class AllowTrustResult:
    type: AllowTrustResultCode
    value: object = None


class AccountMergeResultCode(enum.IntEnum):
    ACCOUNT_MERGE_SUCCESS = 0
    ACCOUNT_MERGE_MALFORMED = -1
    ACCOUNT_MERGE_NO_ACCOUNT = -2
    ACCOUNT_MERGE_IMMUTABLE_SET = -3
    ACCOUNT_MERGE_HAS_SUB_ENTRIES = -4


@xunion(
    xenum(AccountMergeResultCode),
    {AccountMergeResultCode.ACCOUNT_MERGE_SUCCESS: ("sourceAccountBalance", int64)},
    default_void=True,
)
class AccountMergeResult:
    type: AccountMergeResultCode
    value: object = None


class InflationResultCode(enum.IntEnum):
    INFLATION_SUCCESS = 0
    INFLATION_NOT_TIME = -1


@xstruct
class InflationPayout:
    destination: PublicKey = xf(ACCOUNT_ID)
    amount: int = xf(int64, 0)


@xunion(
    xenum(InflationResultCode),
    {
        InflationResultCode.INFLATION_SUCCESS: (
            "payouts",
            var_array(InflationPayout._codec),
        )
    },
    default_void=True,
)
class InflationResult:
    type: InflationResultCode
    value: object = None


class OperationResultCode(enum.IntEnum):
    opINNER = 0
    opBAD_AUTH = -1
    opNO_ACCOUNT = -2


@xunion(
    xenum(OperationType),
    {
        OperationType.CREATE_ACCOUNT: (
            "createAccountResult",
            CreateAccountResult._codec,
        ),
        OperationType.PAYMENT: ("paymentResult", PaymentResult._codec),
        OperationType.PATH_PAYMENT: ("pathPaymentResult", PathPaymentResult._codec),
        OperationType.MANAGE_OFFER: ("manageOfferResult", ManageOfferResult._codec),
        OperationType.CREATE_PASSIVE_OFFER: (
            "createPassiveOfferResult",
            ManageOfferResult._codec,
        ),
        OperationType.SET_OPTIONS: ("setOptionsResult", SetOptionsResult._codec),
        OperationType.CHANGE_TRUST: ("changeTrustResult", ChangeTrustResult._codec),
        OperationType.ALLOW_TRUST: ("allowTrustResult", AllowTrustResult._codec),
        OperationType.ACCOUNT_MERGE: ("accountMergeResult", AccountMergeResult._codec),
        OperationType.INFLATION: ("inflationResult", InflationResult._codec),
    },
)
class OperationResultTr:
    type: OperationType
    value: object = None


@xunion(
    xenum(OperationResultCode),
    {OperationResultCode.opINNER: ("tr", OperationResultTr._codec)},
    default_void=True,
)
class OperationResult:
    type: OperationResultCode
    value: object = None


class TransactionResultCode(enum.IntEnum):
    txSUCCESS = 0
    txFAILED = -1
    txTOO_EARLY = -2
    txTOO_LATE = -3
    txMISSING_OPERATION = -4
    txBAD_SEQ = -5
    txBAD_AUTH = -6
    txINSUFFICIENT_BALANCE = -7
    txNO_ACCOUNT = -8
    txINSUFFICIENT_FEE = -9
    txBAD_AUTH_EXTRA = -10
    txINTERNAL_ERROR = -11


@xunion(
    xenum(TransactionResultCode),
    {
        TransactionResultCode.txSUCCESS: (
            "results",
            var_array(OperationResult._codec),
        ),
        TransactionResultCode.txFAILED: (
            "failedResults",
            var_array(OperationResult._codec),
        ),
    },
    default_void=True,
)
class TransactionResultResult:
    type: TransactionResultCode
    value: object = None


@xstruct
class TransactionResult:
    feeCharged: int = xf(int64, 0)
    result: TransactionResultResult = xf(
        TransactionResultResult._codec,
        factory=lambda: TransactionResultResult(
            TransactionResultCode.txINTERNAL_ERROR, None
        ),
    )
    ext: int = xf(EXT0, 0)
