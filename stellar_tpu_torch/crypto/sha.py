"""SHA-256 / HMAC-SHA256 / HKDF (reference: src/crypto/SHA.{h,cpp}).

The reference wraps libsodium; hashlib/hmac are the host-side equivalents and
produce identical bytes.  The HKDF here is the reference's two single-step
helpers (SHA.cpp:105-135), NOT full RFC 5869:

- ``hkdf_extract(bytes)``  == HMAC(zero_key, bytes)
- ``hkdf_expand(key, bytes)`` == HMAC(key, bytes || 0x01)
"""

from __future__ import annotations

import hashlib
import hmac as _hmac

ZERO_KEY = b"\x00" * 32


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


class SHA256:
    """Incremental SHA-256 (reference SHA256::create/add/finish)."""

    def __init__(self):
        self._h = hashlib.sha256()
        self._finished = False

    def reset(self) -> None:
        self._h = hashlib.sha256()
        self._finished = False

    def add(self, data: bytes) -> None:
        if self._finished:
            raise RuntimeError("adding bytes to finished SHA256")
        self._h.update(data)

    def finish(self) -> bytes:
        if self._finished:
            raise RuntimeError("finishing already-finished SHA256")
        self._finished = True
        return self._h.digest()


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    return _hmac.new(key, data, hashlib.sha256).digest()


def hmac_sha256_verify(mac: bytes, key: bytes, data: bytes) -> bool:
    return _hmac.compare_digest(mac, hmac_sha256(key, data))


def hkdf_extract(data: bytes) -> bytes:
    """Unsalted HKDF-extract == HMAC(<zero>, data) (SHA.cpp:107-115)."""
    return hmac_sha256(ZERO_KEY, data)


def hkdf_expand(key: bytes, data: bytes) -> bytes:
    """Single-step HKDF-expand == HMAC(key, data|0x01) (SHA.cpp:117-128)."""
    return hmac_sha256(key, data + b"\x01")
