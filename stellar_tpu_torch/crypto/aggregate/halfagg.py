"""ed25519 half-aggregation — the certificate core.

"Performance of EdDSA and BLS Signatures in Committee-Based Consensus"
(PAPERS.md, arXiv:2302.00418) shows committee throughput is bounded by the
envelope-verification plane; half-aggregation (Chalkias et al.) changes the
asymptotics without changing keys or signing: given n ed25519 signatures
``(R_i, s_i)`` over ``(A_i, m_i)``, the aggregate certificate is

    agg = R_1 ‖ … ‖ R_n ‖ s̄        with  s̄ = Σ z_i·s_i  (mod L)

— half the size of the signature list (the s-halves collapse into one
scalar), verified with ONE multi-scalar-multiplication check

    (L - s̄)·B + Σ z_i·R_i + Σ (z_i·h_i mod L)·A_i  ==  identity

where ``h_i = SHA-512(R_i‖A_i‖m_i) mod L`` is the standard ed25519
challenge and the ``z_i`` are Fiat-Shamir coefficients bound to the WHOLE
statement list (every R, A and message hash feeds the transcript root), so
splicing a signature between lists, reordering, or tampering with s̄ all
break the equation.  ``z_i`` are 128-bit: forging an aggregate over an
invalid item means hitting a 2^-128 linear relation — *in the prime-order
subgroup*.  The 8-torsion subgroup sees only ``z_i mod 8``: a defect that
is pure torsion (a mixed-torsion A or a mauled R = R₀ + T) survives the
MSM whenever the coefficients conspire mod 8 — grindable Fiat-Shamir odds
of 1/8 per transcript, exactly the failure a plain batch-RLC
note documents.  Soundness therefore additionally requires every A_i and
R_i PROVEN in the prime-order subgroup ([L]·P == identity, ``torsion_free``
in the native engine / ``ref25519.is_torsion_free``).  The proof costs
~one scalar multiplication per point: amortized to zero for validator
keys through the PointCache, paid once per fresh R — the irreducible
price of bit-parity with a cofactorless reference verifier.

Completeness is exact, not probabilistic: if every item passes libsodium's
``crypto_sign_verify_detached`` (byte-compared R), then each
``s_i·B - h_i·A_i - R_i`` is the identity POINT and any linear combination
is too — so an honest batch can never fall back.  The item accept set is
libsodium's: the strict gate (canonical s, small-order R/A, canonical A —
``ref25519.strict_input_ok``) plus canonical-R (libsodium's byte compare
can never accept a non-canonical R; see ``ref25519.agg_input_ok``), and
point decoding is STRICT in both engines.

Point work rides ``native/halfagg.c`` (Pippenger MSM + batch strict
decompress, ~7 µs/point decode on this host) with a pure-Python ref25519
fallback that doubles as the differential oracle.  Decoded validator keys
(the A_i, stable across slots) memoize in a bounded ``PointCache`` so a
steady-state slot pays decompression only for its fresh R_i.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from ...ops import ref25519 as ref

# (pubkey32, msg, sig64) — the SigBackend triple shape
VerifyTriple = Tuple[bytes, bytes, bytes]

DOMAIN = b"stellar-tpu.halfagg.v1"
L = ref.L
_IDENT_ENC = b"\x01" + b"\x00" * 31  # compress((0, 1)) — the identity point
_EXT_BYTES = 160  # native extended-point blob (4 coords x 5 limbs x 8)


def _native():
    from ... import native

    return native.load_halfagg()


def native_available() -> bool:
    return _native() is not None


# ---------------------------------------------------------------------------
# transcript / coefficients
# ---------------------------------------------------------------------------


def _item_digest(pk: bytes, msg: bytes, r: bytes) -> bytes:
    h = hashlib.sha512()
    h.update(r)
    h.update(pk)
    h.update(hashlib.sha512(msg).digest())
    return h.digest()


def transcript_root(pks: Sequence[bytes], msgs: Sequence[bytes],
                    rs: Sequence[bytes]) -> bytes:
    """SHA-512 root binding every (R_i, A_i, m_i) in order."""
    h = hashlib.sha512()
    h.update(DOMAIN)
    h.update(len(pks).to_bytes(8, "little"))
    for pk, msg, r in zip(pks, msgs, rs):
        h.update(_item_digest(pk, msg, r))
    return h.digest()


def coefficients(root: bytes, n: int) -> List[int]:
    """The 128-bit Fiat-Shamir multipliers z_i (z_0 included — a uniform
    rule keeps the native and oracle paths trivially in lockstep)."""
    out = []
    for i in range(n):
        d = hashlib.sha512(
            DOMAIN + b".coeff" + root + i.to_bytes(8, "little")
        ).digest()
        out.append(int.from_bytes(d[:16], "little"))
    return out


def challenge(pk: bytes, msg: bytes, r: bytes) -> int:
    """The standard ed25519 challenge h = SHA-512(R‖A‖M) mod L."""
    return (
        int.from_bytes(hashlib.sha512(r + pk + msg).digest(), "little") % L
    )


# ---------------------------------------------------------------------------
# the certificate API
# ---------------------------------------------------------------------------


def aggregate(items: Sequence[VerifyTriple]) -> bytes:
    """Half-aggregate: R_1‖…‖R_n‖s̄ (32n + 32 bytes).  Pure scalar work —
    no point operation; aggregation is cheap, verification carries the
    curve math."""
    for pk, _msg, sig in items:
        if len(pk) != 32 or len(sig) != 64:
            raise ValueError(
                "halfagg aggregate needs 32-byte pubkeys and 64-byte "
                f"signatures (got pk={len(pk)}, sig={len(sig)})"
            )
    pks = [it[0] for it in items]
    msgs = [it[1] for it in items]
    rs = [it[2][:32] for it in items]
    zs = coefficients(transcript_root(pks, msgs, rs), len(items))
    s_bar = 0
    for (pk, msg, sig), z in zip(items, zs):
        s_bar = (s_bar + z * int.from_bytes(sig[32:], "little")) % L
    return b"".join(rs) + s_bar.to_bytes(32, "little")


class PointCache:
    """Bounded LRU of strict-decoded, PRIME-ORDER-PROVEN points keyed by
    their compressed encoding — the validator-key (A_i) memo.  Values are
    the native extended-limb blob, or the ref25519 coordinate tuple on
    toolchain-less hosts; ``None`` records a PERMANENT unusability:
    undecodable, or decodable but outside the prime-order subgroup (a
    mixed-torsion key would defeat the cofactorless MSM's soundness).
    Both properties are intrinsic to the encoding, so the negative cache
    keeps a hostile peer from making the node re-derive the same failed
    square root — or re-run the same [L]·P ladder — every slot."""

    def __init__(self, capacity: int = 0x10000):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._map: OrderedDict = OrderedDict()

    def get_many(self, encs: Sequence[bytes]) -> list:
        out = []
        with self._lock:
            for e in encs:
                if e in self._map:
                    self._map.move_to_end(e)
                    out.append(self._map[e])
                else:
                    out.append(False)  # miss marker (None = cached failure)
        return out

    def put_many(self, pairs) -> None:
        with self._lock:
            for enc, val in pairs:
                self._map[enc] = val
                self._map.move_to_end(enc)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._map)


def _decompress_many(
    encs: Sequence[bytes],
    cache: Optional[PointCache],
    check_torsion: bool = True,
):
    """Strict-decode a point column, through the cache when given.
    Returns a list of native ext blobs / ref tuples, with None for
    unusable encodings — undecodable, or (with ``check_torsion``, the
    default) outside the prime-order subgroup.  ``check_torsion=False``
    defers the [L]·P proof to the caller (the R column runs it only
    after the MSM passes, so a poisoned bucket skips it) and is only
    valid with ``cache=None`` — the cache stores proven points."""
    if not check_torsion and cache is not None:
        raise ValueError(
            "check_torsion=False would cache torsion-unproven points"
        )
    mod = _native()
    vals = cache.get_many(encs) if cache is not None else [False] * len(encs)
    miss = [i for i, v in enumerate(vals) if v is False]
    if miss:
        if mod is not None:
            ok, ext = mod.decompress(b"".join(encs[i] for i in miss))
            for j, i in enumerate(miss):
                vals[i] = (
                    ext[j * _EXT_BYTES : (j + 1) * _EXT_BYTES]
                    if ok[j]
                    else None
                )
        else:
            for i in miss:
                enc = encs[i]
                pt = (
                    ref.decompress(enc)
                    if ref.fe_is_canonical(enc)
                    else None
                )
                vals[i] = pt
        if check_torsion:
            decoded = [i for i in miss if vals[i] is not None]
            if decoded:
                free = _torsion_free_many([vals[i] for i in decoded])
                for i, tf in zip(decoded, free):
                    if not tf:
                        vals[i] = None
        if cache is not None:
            cache.put_many((encs[i], vals[i]) for i in miss)
    return vals


def torsion_free_encs(encs: Sequence[bytes]) -> List[bool]:
    """Host prime-order proofs straight from compressed encodings: True
    iff the encoding is canonical, strict-decodable AND torsion-free.
    This is the SigBackend.torsion_check host path (and the oracle the
    device batch-plane prover is differential-tested against)."""
    out = [False] * len(encs)
    well = [i for i, e in enumerate(encs) if len(e) == 32]
    if not well:
        return out
    vals = _decompress_many([encs[i] for i in well], None, check_torsion=False)
    idx = [k for k, v in enumerate(vals) if v is not None]
    free = _torsion_free_many([vals[k] for k in idx])
    for k, tf in zip(idx, free):
        out[well[k]] = tf
    return out


def torsion_free_points(vals: Sequence) -> List[bool]:
    """Prime-order proofs over ALREADY-DECODED points (the non-None
    values ``_decompress_many`` returns) — the re-decode-free host path
    for callers that hold both the encodings and the decoded points
    (SigBackend.torsion_check's ``vals`` fast path)."""
    return _torsion_free_many(vals)


def _torsion_free_many(vals: Sequence) -> List[bool]:
    """Prime-order-subgroup proof per decoded point ([L]·P == identity).
    ``vals`` are non-None values from ``_decompress_many`` — native ext
    blobs or ref tuples.  See the module docstring: the cofactorless MSM
    alone has only 1/8 soundness against torsion components, so every
    point the aggregate plane trusts must pass this."""
    mod = _native()
    if not vals:
        return []
    if mod is not None and isinstance(vals[0], bytes):
        ok = mod.torsion_free(b"".join(vals))
        return [bool(b) for b in ok]
    return [ref.is_torsion_free(v) for v in vals]


def _msm_is_identity(points, scalars: Sequence[int]) -> bool:
    """One Pippenger check: Σ scalar_i·P_i == identity.  ``points`` are
    decoded values from ``_decompress_many`` (all non-None)."""
    mod = _native()
    if mod is not None:
        sc = b"".join(s.to_bytes(32, "little") for s in scalars)
        return mod.msm_ext(b"".join(points), sc) == _IDENT_ENC
    acc = ref.IDENT
    for pt, s in zip(points, scalars):
        acc = ref.point_add(acc, ref.scalar_mult(s, pt))
    return ref.point_equal(acc, ref.IDENT)


def verify_aggregated(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    aggsig: bytes,
    point_cache: Optional[PointCache] = None,
    torsion_prover=None,
) -> bool:
    """Verify a half-aggregate certificate against its statement list.
    True ⇒ every (A_i, m_i) carries a signature libsodium would accept
    (up to the 2^-128 batch-soundness bound); any tampered R, spliced
    item, reordered list, or forged s̄ fails.  The accept set is further
    restricted to prime-order A_i and R_i (honest signers never produce
    anything else): a mixed-torsion point would cut the MSM's soundness
    to 1/8, so it is rejected outright — the certificate API has no
    per-item fallback to shelter it."""
    n = len(pks)
    if len(msgs) != n or len(aggsig) != 32 * n + 32:
        return False
    rs = [aggsig[32 * i : 32 * i + 32] for i in range(n)]
    s_bar = int.from_bytes(aggsig[32 * n :], "little")
    if s_bar >= L:
        return False
    # item gate: small-order R/A and non-canonical A/R are outside
    # libsodium's accept set regardless of any equation
    for pk, r in zip(pks, rs):
        if not (
            len(pk) == 32
            and ref.fe_is_canonical(pk)
            and not ref.has_small_order(pk)
            and ref.fe_is_canonical(r)
            and not ref.has_small_order(r)
        ):
            return False
    if n == 0:
        return s_bar == 0
    a_pts = _decompress_many(list(pks), point_cache)
    r_pts = _decompress_many(rs, None, check_torsion=False)
    if any(p is None for p in a_pts) or any(p is None for p in r_pts):
        return False
    zs = coefficients(transcript_root(pks, msgs, rs), n)
    hs = [challenge(pk, msg, r) for pk, msg, r in zip(pks, msgs, rs)]
    b_pt = _decompress_many([_BASE_ENC], _base_cache)[0]
    points = [b_pt] + r_pts + a_pts
    scalars = [(L - s_bar) % L] + zs + [
        (z * h) % L for z, h in zip(zs, hs)
    ]
    if not _msm_is_identity(points, scalars):
        return False
    # the MSM is blind to torsion whenever the z_i conspire mod 8; only
    # a prime-order proof of the fresh R column closes the 1/8 hole (the
    # A column was proven inside _decompress_many, cached).  A
    # torsion_prover (the device batch plane, SigBackend.torsion_check)
    # serves the proofs from the R ENCODINGS — already proven canonical
    # and decodable above, so prover and host ladder agree bit-exactly;
    # the decoded r_pts ride along so a host-riding prover (cutover,
    # wedge latch) never re-decodes what this pass already decoded.
    if torsion_prover is not None:
        return all(torsion_prover(rs, r_pts))
    return all(_torsion_free_many(r_pts))


_BASE_ENC = ref.compress(ref.base_point())
_base_cache = PointCache(capacity=4)


def verify_batch_aggregated(
    items: Sequence[VerifyTriple],
    point_cache: Optional[PointCache] = None,
    gated: bool = False,
    torsion_prover=None,
) -> bool:
    """Aggregate-then-verify a batch of full signatures in one check —
    the node-local form the SCP scheme uses (the node holds every s_i; a
    wire-format certificate would drop them).  Semantically identical to
    ``verify_aggregated(aggregate(items))`` minus one transcript pass.
    ``gated=True`` skips the per-item strict gate (the caller already
    ran ``agg_input_ok_batch`` and excluded the rejects).
    ``torsion_prover`` ((encs, decoded_pts) -> [bool]) serves the
    post-MSM fresh-R prime-order proofs — the scheme passes the
    backend's device batch plane here (ROADMAP #3 remainder (a));
    None = the host ladder."""
    n = len(items)
    if n == 0:
        return True
    pks = [it[0] for it in items]
    msgs = [it[1] for it in items]
    rs = [it[2][:32] for it in items]
    if not gated:
        for pk, msg, sig in items:
            if len(sig) != 64 or not ref.agg_input_ok(pk, sig):
                return False
    a_pts = _decompress_many(pks, point_cache)
    if any(p is None for p in a_pts):
        return False
    r_pts = _decompress_many(rs, None, check_torsion=False)
    if any(p is None for p in r_pts):
        return False
    zs = coefficients(transcript_root(pks, msgs, rs), n)
    hs = [challenge(pk, msg, r) for pk, msg, r in zip(pks, msgs, rs)]
    s_bar = 0
    for (pk, msg, sig), z in zip(items, zs):
        s_bar = (s_bar + z * int.from_bytes(sig[32:], "little")) % L
    b_pt = _decompress_many([_BASE_ENC], _base_cache)[0]
    points = [b_pt] + r_pts + a_pts
    scalars = [(L - s_bar) % L] + zs + [
        (z * h) % L for z, h in zip(zs, hs)
    ]
    if not _msm_is_identity(points, scalars):
        return False
    # cofactorless-MSM pass alone is 1/8-sound against a mauled R = R₀+T;
    # only latch-grade once every fresh R is proven prime-order (A column
    # proven via the cache in _decompress_many; B is prime-order).  The
    # prover sees the R ENCODINGS (canonical + decodable by this point),
    # where device and host ladders agree bit-exactly, plus the decoded
    # r_pts so a host-riding prover skips the second decompress pass.
    if torsion_prover is not None:
        return all(torsion_prover(rs, r_pts))
    return all(_torsion_free_many(r_pts))
