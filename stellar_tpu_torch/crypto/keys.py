"""Key management: SecretKey / PubKeyUtils (reference: src/crypto/SecretKey.*).

Signing and eager verification go through libsodium (ctypes, see sodium.py);
verification results are memoized in the global LRU cache exactly like the
reference's gVerifySigCache (SecretKey.cpp:29-52): 65,535 entries keyed
SHA256(pubkey ‖ sig ‖ msg), with hit/miss counters surfaced to metrics.

Where libsodium does not load (the GPU machine), keys and signatures come
from the pure-Python RFC 8032 code in ``ops/ref25519.py`` (the same bytes),
and an eager verify runs ``ref25519.verify`` (the same verdicts, pinned by
tests/test_torch_keys.py).  ``stats()`` counts those eager ref25519
verifies: a node prewarms valid signatures through the batch plane, so
they reach the eager path as cache hits, and the count shows what did not.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Tuple

from ..ops import ref25519 as ref
from ..xdr.xtypes import PublicKey
from . import sodium, strkey
from .sha import sha256
from .sigcache import VerifySigCache

# process-wide verify cache (reference SecretKey.cpp:30: lru_cache(0xffff))
_verify_cache = VerifySigCache(0xFFFF)

_stats_lock = threading.Lock()
_eager_ref_verifies = 0  # guarded by _stats_lock


def _verify_detached(signature: bytes, msg: bytes, key_raw: bytes) -> bool:
    """libsodium's crypto_sign_verify_detached, else ref25519.verify."""
    global _eager_ref_verifies
    if sodium.available():
        return sodium.verify_detached(signature, msg, key_raw)
    with _stats_lock:
        _eager_ref_verifies += 1
    if len(signature) != 64 or len(key_raw) != 32:
        return False
    return ref.verify(key_raw, msg, signature)


def stats() -> dict:
    """Eager verifies that ran ref25519 (no libsodium) since the last reset."""
    with _stats_lock:
        return {"eager_ref_verifies": _eager_ref_verifies}


def reset_stats() -> None:
    global _eager_ref_verifies
    with _stats_lock:
        _eager_ref_verifies = 0


class SecretKey:
    """Ed25519 secret key wrapping a libsodium (seed, sk64) pair, or the
    seed alone where libsodium does not load."""

    __slots__ = ("_seed", "_sk64", "_pk_raw", "_pk")

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
        self._pk = PublicKey.from_ed25519(self._pk_raw)

    # -- constructors ------------------------------------------------------
    @classmethod
    def random(cls) -> "SecretKey":
        return cls(sodium.randombytes(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "SecretKey":
        return cls(seed)

    @classmethod
    def from_strkey_seed(cls, s: str) -> "SecretKey":
        return cls(strkey.from_seed_strkey(s))

    @classmethod
    def pseudo_random_for_testing(cls, n: int) -> "SecretKey":
        """Deterministic per-index test key (the reference's getTestAccount
        style: derived, reproducible, NOT secure)."""
        return cls(sha256(b"stellar_tpu test seed %d" % n))

    # -- accessors ---------------------------------------------------------
    def get_public_key(self) -> PublicKey:
        return self._pk

    @property
    def public_raw(self) -> bytes:
        return self._pk_raw

    def get_seed(self) -> bytes:
        return self._seed

    def get_strkey_seed(self) -> str:
        return strkey.to_seed_strkey(self._seed)

    def get_strkey_public(self) -> str:
        return strkey.to_account_strkey(self._pk_raw)

    # -- operations --------------------------------------------------------
    def sign(self, msg: bytes) -> bytes:
        if self._sk64 is not None:
            return sodium.sign_detached(msg, self._sk64)
        return ref.sign_with_seed(self._seed, msg)

    def __repr__(self):
        return f"SecretKey({self.get_strkey_public()[:8]}…)"


class PubKeyUtils:
    """Static helpers mirroring the reference's PubKeyUtils."""

    @staticmethod
    def verify_sig(key: PublicKey, signature: bytes, msg: bytes) -> bool:
        """Cached eager verify (SecretKey.cpp:254-286)."""
        cache_key = _verify_cache.key_for(key.value, signature, msg)
        hit, val = _verify_cache.get(cache_key)
        if hit:
            return val
        ok = _verify_detached(signature, msg, key.value)
        # valid verdicts only: the bounded LRU must be un-pollutable by a
        # flood of distinct invalid-sig items (same contract as the batch
        # paths in sigbackend.py; re-verifying an invalid item is pure)
        if ok:
            # analysis: off cache-latch -- synchronous single-verify memoization on the caller's own thread (the reference's SecretKey.cpp eager path): the verdict was just computed against live state, there is no async batch to quarantine
            _verify_cache.put(cache_key, ok)
        return ok

    @staticmethod
    def verify_sig_uncached(key_raw: bytes, signature: bytes, msg: bytes) -> bool:
        return _verify_detached(signature, msg, key_raw)

    @staticmethod
    def get_hint(pk: PublicKey) -> bytes:
        """Last 4 bytes of the public key (SecretKey.cpp:333-338)."""
        return pk.value[-4:]

    @staticmethod
    def has_hint(pk: PublicKey, hint: bytes) -> bool:
        return pk.value[-4:] == hint

    @staticmethod
    def to_short_string(pk: PublicKey) -> str:
        return strkey.to_account_strkey(pk.value)[:8]

    @staticmethod
    def to_strkey(pk: PublicKey) -> str:
        return strkey.to_account_strkey(pk.value)

    @staticmethod
    def from_strkey(s: str) -> PublicKey:
        return PublicKey.from_ed25519(strkey.from_account_strkey(s))

    @staticmethod
    def random() -> PublicKey:
        return PublicKey.from_ed25519(sodium.randombytes(32))

    # cache introspection (SecretKey.cpp:241-252)
    @staticmethod
    def flush_verify_sig_cache_counts() -> Tuple[int, int]:
        return _verify_cache.flush_counts()

    @staticmethod
    def clear_verify_sig_cache() -> None:
        _verify_cache.clear()


def verify_cache() -> VerifySigCache:
    return _verify_cache
