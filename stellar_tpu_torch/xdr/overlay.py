"""Wire types from the reference's src/xdr/Stellar-overlay.x (161 lines)."""

from __future__ import annotations

import enum
from typing import List

from .base import (
    int32,
    opaque,
    string,
    uint32,
    uint64,
    var_array,
    xenum,
    xf,
    xstruct,
    xunion,
)
from .ledger import TransactionSet
from .scp import SCPEnvelope, SCPQuorumSet
from .txs import TransactionEnvelope
from .xtypes import (
    HASH,
    SIGNATURE,
    UINT256,
    Curve25519Public,
    HmacSha256Mac,
    PublicKey,
)


class ErrorCode(enum.IntEnum):
    ERR_MISC = 0
    ERR_DATA = 1
    ERR_CONF = 2
    ERR_AUTH = 3
    ERR_LOAD = 4


@xstruct
class Error:
    code: ErrorCode = xf(xenum(ErrorCode), ErrorCode.ERR_MISC)
    msg: str = xf(string(100), "")


@xstruct
class AuthCert:
    pubkey: Curve25519Public = xf(Curve25519Public._codec)
    expiration: int = xf(uint64, 0)
    sig: bytes = xf(SIGNATURE, b"")


@xstruct
class Hello:
    ledgerVersion: int = xf(uint32, 0)
    overlayVersion: int = xf(uint32, 0)
    networkID: bytes = xf(HASH, b"\x00" * 32)
    versionStr: str = xf(string(100), "")
    listeningPort: int = xf(int32, 0)
    peerID: PublicKey = xf(PublicKey._codec)
    cert: AuthCert = xf(AuthCert._codec)
    nonce: bytes = xf(UINT256, b"\x00" * 32)


@xstruct
class Hello2:
    ledgerVersion: int = xf(uint32, 0)
    overlayVersion: int = xf(uint32, 0)
    overlayMinVersion: int = xf(uint32, 0)
    networkID: bytes = xf(HASH, b"\x00" * 32)
    versionStr: str = xf(string(100), "")
    listeningPort: int = xf(int32, 0)
    peerID: PublicKey = xf(PublicKey._codec)
    cert: AuthCert = xf(AuthCert._codec)
    nonce: bytes = xf(UINT256, b"\x00" * 32)


@xstruct
class Auth:
    unused: int = xf(int32, 0)


class IPAddrType(enum.IntEnum):
    IPv4 = 0
    IPv6 = 1


@xunion(
    xenum(IPAddrType),
    {IPAddrType.IPv4: ("ipv4", opaque(4)), IPAddrType.IPv6: ("ipv6", opaque(16))},
)
class PeerAddressIp:
    type: IPAddrType
    value: object = None


@xstruct
class PeerAddress:
    ip: PeerAddressIp = xf(PeerAddressIp._codec)
    port: int = xf(uint32, 0)
    numFailures: int = xf(uint32, 0)


class MessageType(enum.IntEnum):
    ERROR_MSG = 0
    HELLO = 1
    AUTH = 2
    DONT_HAVE = 3
    GET_PEERS = 4
    PEERS = 5
    GET_TX_SET = 6
    TX_SET = 7
    TRANSACTION = 8
    GET_SCP_QUORUMSET = 9
    SCP_QUORUMSET = 10
    SCP_MESSAGE = 11
    GET_SCP_STATE = 12
    HELLO2 = 13


@xstruct
class DontHave:
    type: MessageType = xf(xenum(MessageType), MessageType.TX_SET)
    reqHash: bytes = xf(UINT256, b"\x00" * 32)


@xunion(
    xenum(MessageType),
    {
        MessageType.ERROR_MSG: ("error", Error._codec),
        MessageType.HELLO: ("hello", Hello._codec),
        MessageType.HELLO2: ("hello2", Hello2._codec),
        MessageType.AUTH: ("auth", Auth._codec),
        MessageType.DONT_HAVE: ("dontHave", DontHave._codec),
        MessageType.GET_PEERS: None,
        MessageType.PEERS: ("peers", var_array(PeerAddress._codec)),
        MessageType.GET_TX_SET: ("txSetHash", UINT256),
        MessageType.TX_SET: ("txSet", TransactionSet._codec),
        MessageType.TRANSACTION: ("transaction", TransactionEnvelope._codec),
        MessageType.GET_SCP_QUORUMSET: ("qSetHash", UINT256),
        MessageType.SCP_QUORUMSET: ("qSet", SCPQuorumSet._codec),
        MessageType.SCP_MESSAGE: ("envelope", SCPEnvelope._codec),
        MessageType.GET_SCP_STATE: ("getSCPLedgerSeq", uint32),
    },
)
class StellarMessage:
    type: MessageType
    value: object = None


@xstruct
class AuthenticatedMessageV0:
    sequence: int = xf(uint64, 0)
    message: StellarMessage = xf(StellarMessage._codec)
    mac: HmacSha256Mac = xf(
        HmacSha256Mac._codec, factory=lambda: HmacSha256Mac(b"\x00" * 32)
    )


@xunion(uint32, {0: ("v0", AuthenticatedMessageV0._codec)})
class AuthenticatedMessage:
    type: int
    value: object = None

    @classmethod
    def v0_of(cls, sequence: int, message: StellarMessage, mac: bytes) -> "AuthenticatedMessage":
        return cls(0, AuthenticatedMessageV0(sequence, message, HmacSha256Mac(mac)))
