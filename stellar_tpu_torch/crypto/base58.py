"""Base58 / base58-check encodings (reference: src/crypto/Base58.{h,cpp}).

Deprecated in-reference in favor of strkey (crypto/strkey.py carries the
live identity encodings) but kept for strict capability parity: both the
bitcoin alphabet and the shuffled "stellar" alphabet, plus the
version-byte + double-SHA256-checksum check encoding.  Python ints
replace the reference's digit-vector bignum loops; identical outputs
(reference test vectors in tests/test_crypto.py).
"""

from __future__ import annotations

from typing import Tuple

from .sha import sha256

BITCOIN_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
STELLAR_ALPHABET = "gsphnaf39wBUDNEGHJKLM4PQRST7VWXYZ2bcdeCr65jkm8oFqi1tuvAxyz"

# version bytes (reference Base58.h Base58CheckVersionByte)
VER_ACCOUNT_ID = 0  # 'g' in the stellar alphabet
VER_SEED = 33  # 's'


def base_encode(data: bytes, alphabet: str = BITCOIN_ALPHABET) -> str:
    if not data:
        return ""
    n = int.from_bytes(data, "big")
    digits = []
    while n > 0:
        n, r = divmod(n, 58)
        digits.append(alphabet[r])
    if not digits:  # value part is at least one zero digit
        digits.append(alphabet[0])
    # preserve leading zero bytes as leading zero-digits (all but the last
    # byte, mirroring the reference's append-leading-zeroes loop)
    pad = 0
    for b in data[: len(data) - 1]:
        if b != 0:
            break
        pad += 1
    return alphabet[0] * pad + "".join(reversed(digits))


def base_decode(encoded: str, alphabet: str = BITCOIN_ALPHABET) -> bytes:
    if not encoded:
        return b""
    n = 0
    for c in encoded:
        idx = alphabet.find(c)
        if idx < 0:
            raise ValueError(f"unknown character {c!r} in base58 decode")
        n = n * 58 + idx
    out = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b"\x00"
    # restore leading zeros (all but the last character)
    pad = 0
    for c in encoded[: len(encoded) - 1]:
        if c != alphabet[0]:
            break
        pad += 1
    # n == 0 already produced one zero byte
    if n == 0:
        return b"\x00" * (pad + 1)
    return b"\x00" * pad + out


def base_check_encode(
    ver: int, data: bytes, alphabet: str = STELLAR_ALPHABET
) -> str:
    vb = bytes([ver]) + data
    checksum = sha256(sha256(vb))[:4]
    return base_encode(vb + checksum, alphabet)


def base_check_decode(
    encoded: str, alphabet: str = STELLAR_ALPHABET
) -> Tuple[int, bytes]:
    raw = base_decode(encoded, alphabet)
    if len(raw) < 5:
        raise ValueError("base58-check decoded to <5 bytes")
    body, checksum = raw[:-4], raw[-4:]
    if sha256(sha256(body))[:4] != checksum:
        raise ValueError("base58-check checksum failed")
    return body[0], body[1:]
