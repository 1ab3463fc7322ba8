"""ctypes bindings to the system libsodium — the CPU ground truth.

The reference links libsodium statically (lib/libsodium submodule); we bind
the shared library.  ``crypto_sign_verify_detached`` here is the bit-exactness
oracle the GPU backend (stellar_tpu_torch/ops) must agree with on every input.

The GPU machine has no libsodium.  There the peer-auth primitives run without
it: ``randombytes`` reads ``os.urandom`` and ``scalarmult``/``scalarmult_base``
run the pure-Python RFC 7748 X25519 (``x25519.py``), which refuses an
all-zero shared secret as libsodium does.  Signing, verifying and the
verify function's address still need libsodium (``crypto/keys.py`` and the
cpu backend decide what runs without it).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

from . import x25519

_lib: Optional[ctypes.CDLL] = None
_missing = False  # a failed search is not repeated (find_library is slow)


def _load() -> ctypes.CDLL:
    global _lib, _missing
    if _lib is not None:
        return _lib
    if _missing:
        raise RuntimeError("libsodium not found")
    name = ctypes.util.find_library("sodium")
    for cand in ([name] if name else []) + [
        "libsodium.so.23",
        "libsodium.so",
        "libsodium.dylib",
    ]:
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        if lib.sodium_init() < 0:
            raise RuntimeError("sodium_init failed")
        _lib = lib
        return lib
    _missing = True
    raise RuntimeError("libsodium not found")


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def sign_seed_keypair(seed: bytes) -> tuple:
    """(public_key_32, secret_key_64) from a 32-byte seed."""
    lib = _load()
    pk = ctypes.create_string_buffer(32)
    sk = ctypes.create_string_buffer(64)
    if lib.crypto_sign_seed_keypair(pk, sk, seed) != 0:
        raise RuntimeError("crypto_sign_seed_keypair failed")
    return pk.raw, sk.raw


def sign_detached(msg: bytes, secret_key64: bytes) -> bytes:
    lib = _load()
    sig = ctypes.create_string_buffer(64)
    siglen = ctypes.c_ulonglong(0)
    if (
        lib.crypto_sign_detached(
            sig, ctypes.byref(siglen), msg, ctypes.c_ulonglong(len(msg)), secret_key64
        )
        != 0
    ):
        raise RuntimeError("crypto_sign_detached failed")
    return sig.raw


def verify_detached(sig: bytes, msg: bytes, public_key32: bytes) -> bool:
    if len(sig) != 64 or len(public_key32) != 32:
        return False
    lib = _load()
    return (
        lib.crypto_sign_verify_detached(
            sig, msg, ctypes.c_ulonglong(len(msg)), public_key32
        )
        == 0
    )


def verify_fn_addr() -> int:
    """Address of ``crypto_sign_verify_detached`` in the loaded libsodium
    — handed to the native sighash worker pool so its C tiles can call
    libsodium directly with the GIL released (one verifier, two callers:
    crypto/sigbackend routes large pure-CPU batches through the pool and
    keeps this module's serial loop for small batches / 1-core hosts)."""
    lib = _load()
    addr = ctypes.cast(lib.crypto_sign_verify_detached, ctypes.c_void_p).value
    if not addr:
        raise RuntimeError("crypto_sign_verify_detached unresolved")
    return addr


def randombytes(n: int) -> bytes:
    if not available():
        return os.urandom(n)
    lib = _load()
    buf = ctypes.create_string_buffer(n)
    lib.randombytes_buf(buf, ctypes.c_size_t(n))
    return buf.raw


def scalarmult_base(secret32: bytes) -> bytes:
    if not available():
        return x25519.scalarmult_base(secret32)
    lib = _load()
    out = ctypes.create_string_buffer(32)
    if lib.crypto_scalarmult_base(out, secret32) != 0:
        raise RuntimeError("crypto_scalarmult_base failed")
    return out.raw


def scalarmult(secret32: bytes, public32: bytes) -> bytes:
    if not available():
        return x25519.scalarmult(secret32, public32)
    lib = _load()
    out = ctypes.create_string_buffer(32)
    if lib.crypto_scalarmult(out, secret32, public32) != 0:
        raise RuntimeError("crypto_scalarmult failed (weak public key)")
    return out.raw
