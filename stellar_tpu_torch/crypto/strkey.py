"""StrKey: base32 + CRC16-XModem key encoding (reference: src/crypto/StrKey.*,
lib/util/crc16.cpp, lib/util/basen.h).

Format: base32( version_byte<<3 ‖ payload ‖ crc16_le ).  32-byte payloads
encode to exactly 56 chars with no padding ('G...' pubkeys, 'S...' seeds).
"""

from __future__ import annotations

import base64
from functools import lru_cache
from typing import Tuple

# 5-bit version bytes (StrKey.h:18-20)
STRKEY_PUBKEY_ED25519 = 6  # 'G'
STRKEY_SEED_ED25519 = 18  # 'S'


def _crc16_table() -> list:
    tab = []
    for hi in range(256):
        crc = hi << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
        tab.append(crc & 0xFFFF)
    return tab


_CRC16_TAB = _crc16_table()


def crc16(data: bytes) -> int:
    """CRC16-CCITT XModem: poly 0x1021, init 0 (lib/util/crc16.cpp);
    byte-wise table lookup (the bit-loop was the hottest non-SQL function
    in the ledger-close profile — strkeys are SQL row keys)."""
    crc = 0
    tab = _CRC16_TAB
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ tab[(crc >> 8) ^ b]
    return crc


def to_strkey(version: int, payload: bytes) -> str:
    raw = bytes([(version << 3) & 0xFF]) + payload
    c = crc16(raw)
    raw += bytes([c & 0xFF, (c >> 8) & 0xFF])
    return base64.b32encode(raw).decode("ascii").rstrip("=")


def from_strkey(s: str) -> Tuple[int, bytes]:
    """Returns (version, payload); raises ValueError on any corruption."""
    pad = (-len(s)) % 8
    try:
        raw = base64.b32decode(s + "=" * pad)
    except Exception as e:
        raise ValueError(f"bad base32: {e}") from e
    if len(raw) < 3:
        raise ValueError("strkey too short")
    body, crc_lo, crc_hi = raw[:-2], raw[-2], raw[-1]
    if crc16(body) != (crc_hi << 8 | crc_lo):
        raise ValueError("strkey checksum mismatch")
    return body[0] >> 3, body[1:]


# Only the ACCOUNT paths are cached: they are the ledger's SQL row keys
# (hot in the close path), and caching the generic functions would retain
# secret 'S...' seeds in a long-lived global dict.
@lru_cache(maxsize=65536)
def to_account_strkey(pubkey: bytes) -> str:
    return to_strkey(STRKEY_PUBKEY_ED25519, pubkey)


@lru_cache(maxsize=65536)
def from_account_strkey(s: str) -> bytes:
    ver, payload = from_strkey(s)
    if ver != STRKEY_PUBKEY_ED25519 or len(payload) != 32:
        raise ValueError("not an ed25519 account strkey")
    return payload


def to_seed_strkey(seed: bytes) -> str:
    return to_strkey(STRKEY_SEED_ED25519, seed)


def from_seed_strkey(s: str) -> bytes:
    ver, payload = from_strkey(s)
    if ver != STRKEY_SEED_ED25519 or len(payload) != 32:
        raise ValueError("not an ed25519 seed strkey")
    return payload


def hex_encode(data: bytes) -> str:
    return data.hex()


def hex_decode(s: str) -> bytes:
    return bytes.fromhex(s)
