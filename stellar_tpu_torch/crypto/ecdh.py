"""Curve25519 ECDH for peer session keys (reference: src/crypto/ECDH.cpp).

Never reuses ed25519 identity keys — ephemeral curve25519 only (ECDH.h:13-24).
Shared key = hkdf_extract( scalarmult(local_sec, remote_pub) ‖ pubA ‖ pubB )
where (pubA, pubB) is (local, remote) ordered by who called first.
"""

from __future__ import annotations

from . import sodium
from .sha import hkdf_extract


def ecdh_random_secret() -> bytes:
    return sodium.randombytes(32)


def ecdh_derive_public(secret: bytes) -> bytes:
    return sodium.scalarmult_base(secret)


def ecdh_derive_shared_key(
    local_secret: bytes,
    local_public: bytes,
    remote_public: bytes,
    local_first: bool,
) -> bytes:
    public_a = local_public if local_first else remote_public
    public_b = remote_public if local_first else local_public
    q = sodium.scalarmult(local_secret, remote_public)
    return hkdf_extract(q + public_a + public_b)
