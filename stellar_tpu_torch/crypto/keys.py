"""The part of the node's key management the verify plane and its fixtures
need: ``SecretKey`` (seeded keys, signing) and the process-wide verify
cache.  The XDR and strkey surfaces of the JAX package's ``crypto/keys.py``
are not part of the port.

Keys and signatures come from libsodium when it loads, else from the
pure-Python RFC 8032 code in ``ops/ref25519.py`` — the same bytes either way.
"""

from __future__ import annotations

import hashlib

from ..ops import ref25519 as ref
from . import sodium
from .sigcache import VerifySigCache

# process-wide verify cache (reference SecretKey.cpp:30: lru_cache(0xffff))
_verify_cache = VerifySigCache(0xFFFF)


class SecretKey:
    """Ed25519 secret key from a 32-byte seed."""

    __slots__ = ("_seed", "_sk64", "_pk_raw")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self._seed = bytes(seed)
        if sodium.available():
            self._pk_raw, self._sk64 = sodium.sign_seed_keypair(self._seed)
        else:
            a = int.from_bytes(hashlib.sha512(self._seed).digest()[:32], "little")
            a = (a & ((1 << 254) - 8)) | (1 << 254)
            self._pk_raw = ref.compress(ref.scalar_mult(a, ref.base_point()))
            self._sk64 = None

    @classmethod
    def from_seed(cls, seed: bytes) -> "SecretKey":
        return cls(seed)

    @classmethod
    def pseudo_random_for_testing(cls, n: int) -> "SecretKey":
        """Deterministic per-index test key — the JAX package's derivation,
        so fixtures match key for key."""
        return cls(hashlib.sha256(b"stellar_tpu test seed %d" % n).digest())

    @property
    def public_raw(self) -> bytes:
        return self._pk_raw

    def get_seed(self) -> bytes:
        return self._seed

    def sign(self, msg: bytes) -> bytes:
        if self._sk64 is not None:
            return sodium.sign_detached(msg, self._sk64)
        return ref.sign_with_seed(self._seed, msg)


def verify_cache() -> VerifySigCache:
    return _verify_cache
