"""Wire types from the reference's src/xdr/Stellar-types.x (55 lines)."""

from __future__ import annotations

import enum

from .base import (
    opaque,
    uint32,
    var_opaque,
    xenum,
    xf,
    xstruct,
    xunion,
)

HASH = opaque(32)
UINT256 = opaque(32)
SIGNATURE = var_opaque(64)
SIGNATURE_HINT = opaque(4)


class CryptoKeyType(enum.IntEnum):
    KEY_TYPE_ED25519 = 0


@xunion(xenum(CryptoKeyType), {CryptoKeyType.KEY_TYPE_ED25519: ("ed25519", UINT256)})
class PublicKey:
    # never mutated in place anywhere in the tree — xdr_copy shares instances
    XDR_VALUE_SEMANTICS = True

    type: CryptoKeyType
    value: bytes = None

    @classmethod
    def from_ed25519(cls, raw: bytes) -> "PublicKey":
        return cls(CryptoKeyType.KEY_TYPE_ED25519, bytes(raw))

    def __hash__(self):
        return hash((int(self.type), self.value))


PUBLIC_KEY = PublicKey._codec
NODE_ID = PUBLIC_KEY  # typedef PublicKey NodeID
NodeID = PublicKey


@xstruct
class Curve25519Secret:
    key: bytes = xf(opaque(32))


@xstruct
class Curve25519Public:
    key: bytes = xf(opaque(32))


@xstruct
class HmacSha256Key:
    key: bytes = xf(opaque(32))


@xstruct
class HmacSha256Mac:
    mac: bytes = xf(opaque(32))
