"""X25519 (RFC 7748 §5) in pure Python — the peer-auth key exchange where
libsodium does not load.

Same bytes as libsodium's ``crypto_scalarmult_curve25519``: the scalar is
clamped, the u-coordinate's top bit is ignored and a non-canonical u is
reduced mod p, and a result of all zeros (a low-order or zero public
value) is refused, as libsodium refuses it.  Held against libsodium by
tests/test_torch_keys.py.
"""

from __future__ import annotations

P = 2**255 - 19
A24 = 121665
BASE_U = 9


def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _ladder(k: int, u: int) -> int:
    """The RFC 7748 §5 Montgomery ladder: u-coordinate of [k]·(u, ·)."""
    x1 = u
    x2, z2, x3, z3 = 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * (z3 * z3 % P) % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, P - 2, P) % P


def scalarmult(secret32: bytes, public32: bytes) -> bytes:
    """X25519(secret, public); raises on an all-zero result."""
    if len(secret32) != 32 or len(public32) != 32:
        raise ValueError("X25519 takes 32-byte inputs")
    u = int.from_bytes(public32, "little") & ((1 << 255) - 1)
    out = _ladder(_clamp(secret32), u % P).to_bytes(32, "little")
    if out == bytes(32):
        raise RuntimeError("crypto_scalarmult failed (weak public key)")
    return out


def scalarmult_base(secret32: bytes) -> bytes:
    if len(secret32) != 32:
        raise ValueError("X25519 takes a 32-byte scalar")
    return _ladder(_clamp(secret32), BASE_U).to_bytes(32, "little")
