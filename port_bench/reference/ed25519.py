"""A plain ed25519 verifier with libsodium's strict rules, frozen here as the
benchmark's reference.

It is written from RFC 8032 and the curve equations in Python integers and
imports nothing of the program under test: it takes the triples' bytes and
nothing else.  ``verify`` is libsodium's ``crypto_sign_verify_detached``
(a build without ``ED25519_COMPAT``):

1. S must be canonical (S < L);
2. R must not be one of the small-order encodings (sign bit ignored);
3. A must be canonical (y < p, sign bit ignored) and not of small order;
4. A must decode;
5. h = SHA-512(R || A || M) mod L, and the encoding of [S]B - [h]A must
   equal R byte for byte (so a non-canonical R never verifies).

``verify_lax`` drops rules 1-3 and decodes A permissively: the cofactorless
equation alone.  It is the control of the benchmark's comparison (it breaks
the strictness that the configurations state), never a verdict.

``base_mult`` and ``encode`` serve the traffic generator's signing.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended coordinates (X, Y, Z, T)
IDENTITY: Point = (0, 1, 1, 0)


def add(p: Point, q: Point) -> Point:
    """add-2008-hwcd-3 (a = -1), complete."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p: Point) -> Point:
    """dbl-2008-hwcd (a = -1)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = b - a
    f = g - c
    h = -a - b
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def negate(p: Point) -> Point:
    return ((-p[0]) % P, p[1], p[2], (-p[3]) % P)


def encode(p: Point) -> bytes:
    zi = pow(p[2], P - 2, P)
    x = p[0] * zi % P
    y = p[1] * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decode(s: bytes, strict: bool = True) -> Optional[Point]:
    """RFC 8032 section 5.1.3.  ``strict`` refuses y >= p; otherwise y is
    taken mod p, as ref10's ``fe_frombytes`` does."""
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    if y >= P:
        if strict:
            return None
        y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == (-u) % P:
        x = x * SQRT_M1 % P
    elif vxx != u:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def point_eq(p: Point, q: Point) -> bool:
    return (p[0] * q[2] - q[0] * p[2]) % P == 0 and (p[1] * q[2] - q[1] * p[2]) % P == 0


@lru_cache(maxsize=1)
def base() -> Point:
    return decode((4 * pow(5, P - 2, P) % P).to_bytes(32, "little"))


@lru_cache(maxsize=1)
def _comb() -> tuple:
    """table[j][d] = d * 16^j * B for the 64 radix-16 digits of a scalar."""
    table = []
    step = base()
    for _ in range(64):
        row = [IDENTITY, step]
        for _ in range(14):
            row.append(add(row[-1], step))
        table.append(tuple(row))
        for _ in range(4):
            step = double(step)
    return tuple(table)


def base_mult(k: int) -> Point:
    """[k]B for 0 <= k < 2^256, by the fixed-base table."""
    acc = IDENTITY
    for j, row in enumerate(_comb()):
        d = (k >> (4 * j)) & 15
        if d:
            acc = add(acc, row[d])
    return acc


def scalar_mult(k: int, p: Point) -> Point:
    acc = IDENTITY
    for i in range(k.bit_length() - 1, -1, -1):
        acc = double(acc)
        if (k >> i) & 1:
            acc = add(acc, p)
    return acc


@lru_cache(maxsize=1)
def torsion_points() -> Tuple[Point, ...]:
    """The 8 points of the 8-torsion subgroup, from a point of order 8 found
    by clearing the prime-order part of decodable points."""
    y = 2
    while True:
        pt = decode(y.to_bytes(32, "little"))
        y += 1
        if pt is None:
            continue
        t = scalar_mult(L, pt)
        if not point_eq(scalar_mult(4, t), IDENTITY):
            break
    pts, q = [], IDENTITY
    for _ in range(8):
        pts.append(q)
        q = add(q, t)
    return tuple(pts)


@lru_cache(maxsize=1)
def small_order_encodings() -> frozenset:
    """libsodium's blacklist, sign bit masked: the y-encodings of the
    8-torsion points (five values) and the non-canonical aliases p and p+1."""
    out = set()
    for pt in torsion_points():
        e = bytearray(encode(pt))
        e[31] &= 0x7F
        out.add(bytes(e))
    out.add(P.to_bytes(32, "little"))
    out.add((P + 1).to_bytes(32, "little"))
    return frozenset(out)


def has_small_order(s: bytes) -> bool:
    e = bytearray(s)
    e[31] &= 0x7F
    return bytes(e) in small_order_encodings()


def gate(pk: bytes, sig: bytes) -> bool:
    """Rules 1-3: the checks libsodium makes before any curve arithmetic."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    if int.from_bytes(sig[32:], "little") >= L or has_small_order(sig[:32]):
        return False
    if (int.from_bytes(pk, "little") & ((1 << 255) - 1)) >= P or has_small_order(pk):
        return False
    return True


def _equation(a: Point, pk: bytes, msg: bytes, sig: bytes) -> bool:
    """encode([S]B - [h]A) == R, S and h taken as they are."""
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
    s = int.from_bytes(sig[32:], "little")
    neg_a = negate(a)
    both = add(base(), neg_a)
    acc = IDENTITY
    for i in range(max(s.bit_length(), h.bit_length()) - 1, -1, -1):
        acc = double(acc)
        bs, bh = (s >> i) & 1, (h >> i) & 1
        if bs and bh:
            acc = add(acc, both)
        elif bs:
            acc = add(acc, base())
        elif bh:
            acc = add(acc, neg_a)
    return encode(acc) == sig[:32]


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """libsodium's strict verdict on one (public key, message, signature)."""
    if not gate(pk, sig):
        return False
    a = decode(pk)
    return a is not None and _equation(a, pk, msg, sig)


def verify_lax(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """The cofactorless equation without the strict rules (the control)."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    a = decode(pk, strict=False)
    return a is not None and _equation(a, pk, msg, sig)


def verify_many(triples) -> list:
    """``verify`` over (pk, msg, sig) triples; a process pool's job."""
    return [verify(pk, msg, sig) for pk, msg, sig in triples]


def verify_lax_many(triples) -> list:
    return [verify_lax(pk, msg, sig) for pk, msg, sig in triples]
