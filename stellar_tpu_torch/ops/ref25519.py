"""Pure-Python edwards25519 arithmetic, written from RFC 8032 / the curve
equations.  Three jobs:

1. independent oracle for differential tests of the port's kernels;
2. source of derived constants (d, sqrt(-1), the small-order blacklist,
   the fixed-base window table) used by stellar_tpu_torch/ops/ed25519.py;
3. host-side strict-input prechecks replicating libsodium's verify gate
   (sc25519_is_canonical / ge25519_is_canonical / ge25519_has_small_order),
   validated against the real libsodium by tests/test_torch_sigbackend.py.

This is NOT a performance path — the CPU fast path is ctypes libsodium.
A copy of the JAX package's ``ops/ref25519.py`` (the port imports nothing
from that package); the two are held equal by tests/test_torch_ed25519.py.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z
IDENT = (0, 1, 1, 0)


def fe_inv(x: int) -> int:
    return pow(x, P - 2, P)


def point_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dd = 2 * Z1 * Z2 % P
    E, F, G, H = B - A, Dd - C, Dd + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p):
    return point_add(p, p)


def scalar_mult(k: int, p):
    q = IDENT
    while k > 0:
        if k & 1:
            q = point_add(q, p)
        p = point_double(p)
        k >>= 1
    return q


def point_equal(p, q) -> bool:
    # x1/z1 == x2/z2 and y1/z1 == y2/z2
    return (
        (p[0] * q[2] - q[0] * p[2]) % P == 0
        and (p[1] * q[2] - q[1] * p[2]) % P == 0
    )


def compress(p) -> bytes:
    zinv = fe_inv(p[2])
    x = p[0] * zinv % P
    y = p[1] * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(s: bytes) -> Optional[Tuple[int, int, int, int]]:
    """RFC 8032 §5.1.3 point decoding; returns None if not on curve."""
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    if y >= P:
        # ref10's fe_frombytes would alias mod p; the strict libsodium gate
        # rejects earlier via is_canonical, but mirror the permissive decode
        y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # x = u v^3 (u v^7)^((p-5)/8)
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (-u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, x * y % P)


# -- base point -------------------------------------------------------------
_BY = 4 * fe_inv(5) % P
_BX = None


def base_point():
    global _BX
    if _BX is None:
        pt = decompress(int.to_bytes(_BY, 32, "little"))
        _BX = pt
    return _BX


# -- small-order blacklist (libsodium ge25519_has_small_order equivalent) ---
@lru_cache(maxsize=1)
def small_order_blacklist() -> Tuple[bytes, ...]:
    """The 7 encodings libsodium blacklists: y-encodings of the 8-torsion
    subgroup (5 distinct with sign bit ignored) plus the two non-canonical
    aliases p and p+1.  Derived here from the curve itself."""
    # find a point of order exactly 8: decompress increasing y until the
    # point has full 8L order structure
    t8 = None
    y = 2
    while t8 is None:
        pt = decompress(int.to_bytes(y, 32, "little"))
        y += 1
        if pt is None:
            continue
        t = scalar_mult(L, pt)
        # t has order dividing 8; order exactly 8 iff 4t is not the identity
        if not point_equal(scalar_mult(4, t), IDENT):
            t8 = t
    encs = set()
    q = IDENT
    for _ in range(8):
        e = bytearray(compress(q))
        e[31] &= 0x7F  # comparisons ignore the sign bit
        encs.add(bytes(e))
        q = point_add(q, t8)
    # non-canonical aliases of y=0 -> p and y=1 -> p+1
    encs.add(int.to_bytes(P, 32, "little"))
    encs.add(int.to_bytes(P + 1, 32, "little"))
    return tuple(sorted(encs))


# -- libsodium strict-verify input gate -------------------------------------
def sc_is_canonical(s: bytes) -> bool:
    return int.from_bytes(s, "little") < L


def fe_is_canonical(s: bytes) -> bool:
    """y-coordinate (sign bit ignored) < p."""
    return (int.from_bytes(s, "little") & ((1 << 255) - 1)) < P


def has_small_order(s: bytes) -> bool:
    e = bytearray(s)
    e[31] &= 0x7F
    return bytes(e) in small_order_blacklist()


def is_torsion_free(pt) -> bool:
    """Prime-order-subgroup membership: [L]·P == identity.  The strict
    gate only rejects SMALL-order encodings; a mixed-torsion point
    (prime-order part plus nonzero 8-torsion) passes it, and the
    cofactorless aggregate MSM has only 1/8 soundness against such
    points — the aggregate plane therefore requires this proof on every
    point it trusts (native twin: halfagg.c ``torsion_free``)."""
    return point_equal(scalar_mult(L, pt), IDENT)


def _le_lt(x_words: "np.ndarray", bound: int) -> "np.ndarray":
    """(N, 4) uint64 little-endian words < bound, vectorized."""
    import numpy as np

    bw = [(bound >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]
    lt = np.zeros(x_words.shape[0], dtype=bool)
    eq = np.ones(x_words.shape[0], dtype=bool)
    for i in range(3, -1, -1):
        w = np.uint64(bw[i])
        lt |= eq & (x_words[:, i] < w)
        eq &= x_words[:, i] == w
    return lt


def strict_input_ok_batch(pk: "np.ndarray", sig: "np.ndarray") -> "np.ndarray":
    """Vectorized ``strict_input_ok`` over a batch: pk (N, 32) uint8,
    sig (N, 64) uint8 -> (N,) bool.  Same accept set as the per-item
    ``strict_input_ok``, vectorized with numpy."""
    import numpy as np

    s_words = np.ascontiguousarray(sig[:, 32:]).view("<u8").reshape(-1, 4)
    ok = _le_lt(s_words, L)  # canonical s

    blacklist = np.stack(
        [np.frombuffer(b, dtype=np.uint8) for b in small_order_blacklist()]
    )  # (B, 32)

    def masked(x):
        m = x.copy()
        m[:, 31] &= 0x7F
        return m

    r_m = masked(sig[:, :32])
    pk_m = masked(pk)
    ok &= ~(r_m[:, None, :] == blacklist[None]).all(axis=2).any(axis=1)
    ok &= ~(pk_m[:, None, :] == blacklist[None]).all(axis=2).any(axis=1)
    # pk_m is already a fresh contiguous uint8 copy from masked()
    pk_words = pk_m.view("<u8").reshape(-1, 4)
    ok &= _le_lt(pk_words, P)  # canonical A (sign bit ignored)
    return ok


def agg_input_ok_batch(pk: "np.ndarray", sig: "np.ndarray") -> "np.ndarray":
    """The aggregate plane's item gate: libsodium's strict gate PLUS a
    canonical-R requirement.  libsodium never decodes R — it compares the
    signature's R bytes against the canonical encoding of s·B - h·A, so a
    non-canonical R can never verify; the aggregate path DOES decode R and
    must therefore reject the non-canonical aliases up front or its accept
    set would exceed libsodium's (verdict-parity contract,
    tests/test_halfagg.py hostile lanes)."""
    import numpy as np

    ok = strict_input_ok_batch(pk, sig)
    r_m = sig[:, :32].copy()
    r_m[:, 31] &= 0x7F
    r_words = r_m.view("<u8").reshape(-1, 4)
    ok &= _le_lt(r_words, P)  # canonical R (sign bit ignored)
    return ok


def agg_input_ok(pk: bytes, sig: bytes) -> bool:
    """Scalar twin of ``agg_input_ok_batch`` (oracle + tiny batches)."""
    return (
        strict_input_ok(pk, sig)
        and len(sig) == 64
        and fe_is_canonical(sig[:32])
    )


def strict_input_ok(pk: bytes, sig: bytes) -> bool:
    """The pre-curve-math reject gate of libsodium crypto_sign_verify_detached
    (non-COMPAT build): non-canonical s, small-order R, non-canonical or
    small-order A are all rejected before any scalar mult."""
    if len(sig) != 64 or len(pk) != 32:
        return False
    if not sc_is_canonical(sig[32:]):
        return False
    if has_small_order(sig[:32]):
        return False
    if not fe_is_canonical(pk) or has_small_order(pk):
        return False
    return True


# -- full reference verify (the oracle) -------------------------------------
def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    if not strict_input_ok(pk, sig):
        return False
    a = decompress(pk)
    if a is None:
        return False
    neg_a = ((P - a[0]) % P, a[1], a[2], (P - a[3]) % P)
    h = (
        int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
    )
    s = int.from_bytes(sig[32:], "little")
    r_check = point_add(scalar_mult(s, base_point()), scalar_mult(h, neg_a))
    return compress(r_check) == sig[:32]


def sign_with_seed(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signing — only used to build test fixtures without libsodium."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    prefix = h[32:]
    A = compress(scalar_mult(a, base_point()))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = compress(scalar_mult(r, base_point()))
    k = int.from_bytes(hashlib.sha512(R + A + msg).digest(), "little") % L
    s = (r + k * a) % L
    return R + int.to_bytes(s, 32, "little")
