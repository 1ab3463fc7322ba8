"""Batched ed25519 verification in PyTorch, and the verify plane around it.

The split is the JAX package's:

- **host**: libsodium's strict input gate (canonical s, canonical A, small-
  order A/R rejection) + SHA-512(R‖A‖M) mod L + packed staging, all in one
  GIL-releasing C pass per chunk (``native/sighash.c``).  With
  ``device_hash`` the host keeps only the gate for single-block messages
  and the card computes h (``ops/sha512.py``, ``csrc/sha512_h.cu``);
- **device**: point decompress of A, Straus double-scalar multiplication
  R' = s·B + h·(−A) with 4-bit windows (shared doublings, niels tables,
  complete a=−1 twisted Edwards formulas), point encoding, byte compare
  against R.  On the card this is the hand-written CUDA kernel
  (``ops/ed25519_cuda.py``, ``csrc/ed25519_verify.cu``); ``verify_kernel``
  and ``_verify_packed`` below are its plain PyTorch version, on the JAX
  package's (20, N) radix-2^13 layout (``ops/fe.py``), and run whenever the
  packed tensor lies on the CPU.

Verification semantics are bit-exact with libsodium
``crypto_sign_verify_detached``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fe, resolve_device
from . import ref25519 as ref
from . import sha512, sha512_cuda
from .sha512 import L_BYTES

D = ref.D
D2 = (2 * ref.D) % ref.P
SQRT_M1 = ref.SQRT_M1
L = ref.L

_D_FE = fe.const_fe(D)
_D2_FE = fe.const_fe(D2)
_SQRT_M1_FE = fe.const_fe(SQRT_M1)

WINDOWS = 64  # 4-bit windows over 256-bit scalars
PIPELINE_DEPTH = 2  # max in-flight device chunks in BatchVerifier.verify

# Signed-digit windows (the JAX package's ``ed25519_pallas._SIGNED_WIN``):
# recode both scalars' radix-16 digits to [-8, 7] with a carry, so the
# tables need only k = 0..8 and a select negates the entry for d < 0.  Read
# at import; the verify wrappers read it at each call when no ``signed`` is
# given.
_SIGNED_WIN = os.environ.get("STELLAR_TPU_SIGNED_WINDOWS", "0") != "0"
SIGNED_ENTRIES = 9  # table entries k = 0..8 of the signed windows


# ---------------------------------------------------------------------------
# point ops — extended coordinates (X:Y:Z:T), a=-1 complete formulas
# ---------------------------------------------------------------------------


def point_identity(n, dtype=torch.int32, device=None):
    zero = torch.zeros((fe.LIMBS, n), dtype=dtype, device=device)
    one = fe.one_fe(n, dtype, device)
    return (zero, one, one, zero)


def point_add(p, q):
    """General extended + extended (add-2008-hwcd-3 shape, 9M)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = fe.mul(fe.sub(Y1, X1), fe.sub(Y2, X2))
    b = fe.mul(fe.add(Y1, X1), fe.add(Y2, X2))
    c = fe.mul(fe.mul(T1, T2), fe.on_device(_D2_FE, T1))
    d = fe.mul_small(fe.mul(Z1, Z2), 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_add_niels(p, n, need_t: bool = True):
    """Extended + precomputed niels (YpX, YmX, T2d, Z2): 8M (7M w/o T).

    ``need_t=False`` when the result feeds a doubling (which ignores T)."""
    X1, Y1, Z1, T1 = p
    YpX2, YmX2, T2d2, Z22 = n
    a = fe.mul(fe.sub(Y1, X1), YmX2)
    b = fe.mul(fe.add(Y1, X1), YpX2)
    c = fe.mul(T1, T2d2)
    d = fe.mul(Z1, Z22)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    t = fe.mul(e, h) if need_t else torch.zeros_like(X1)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), t)


def point_double(p, need_t: bool = True):
    """dbl-2008-hwcd with a=-1: 4S + 4M (3M with ``need_t=False``).

    Doubling never reads the input T, so inside a doubling chain only the
    last double before an addition needs to produce T."""
    X1, Y1, Z1, _ = p
    a = fe.sqr(X1)
    b = fe.sqr(Y1)
    c = fe.mul_small(fe.sqr(Z1), 2)
    d = fe.neg(a)  # a_coef = -1
    e = fe.sub(fe.sub(fe.sqr(fe.add(X1, Y1)), a), b)
    g = fe.add(d, b)
    f = fe.sub(g, c)
    h = fe.sub(d, b)
    t = fe.mul(e, h) if need_t else torch.zeros_like(X1)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), t)


def to_niels(p):
    X, Y, Z, T = p
    return (
        fe.add(Y, X),
        fe.sub(Y, X),
        fe.mul(T, fe.on_device(_D2_FE, T)),
        fe.mul_small(Z, 2),
    )


def point_negate(p):
    X, Y, Z, T = p
    return (fe.neg(X), Y, Z, fe.neg(T))


def compress(p):
    """-> (32, N) int32 bytes, x-parity already folded into byte 31."""
    X, Y, Z, _ = p
    zinv = fe.inv(Z)
    x = fe.mul(X, zinv)
    y = fe.mul(Y, zinv)
    by = fe.bytes_from_limbs(fe.canonical(y))
    sign = fe.parity(x)
    by = torch.cat([by[:31], (by[31] + (sign << 7))[None]], dim=0)
    return by


def decompress(y_limbs, sign):
    """-> (point, fail) matching ref25519.decompress for canonical y."""
    one = fe.one_fe(tuple(y_limbs.shape[1:]), y_limbs.dtype, y_limbs.device)
    yy = fe.sqr(y_limbs)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.on_device(_D_FE, yy)), one)
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    vxx = fe.mul(v, fe.sqr(x))
    ok1 = fe.eq(vxx, u)
    ok2 = fe.eq(vxx, fe.neg(u))
    x = fe.select(ok2, fe.mul(x, fe.on_device(_SQRT_M1_FE, x)), x)
    fail = ~(ok1 | ok2)
    fail = fail | (fe.is_zero(x) & (sign == 1))
    flip = fe.parity(x) != sign
    x = fe.select(flip, fe.neg(x), x)
    return (x, y_limbs, one, fe.mul(x, y_limbs)), fail


# ---------------------------------------------------------------------------
# fixed-base table (host-precomputed from the reference implementation)
# ---------------------------------------------------------------------------


def _base_niels_table_np() -> np.ndarray:
    """(4, 16, 20) int32: niels components of k*B for k=0..15."""
    tab = np.zeros((4, 16, fe.LIMBS), dtype=np.int32)
    for k, (yx_p, yx_m, t2d) in enumerate(base_niels_affine()):
        tab[0, k] = fe.int_to_limbs(yx_p)
        tab[1, k] = fe.int_to_limbs(yx_m)
        tab[2, k] = fe.int_to_limbs(t2d)
        tab[3, k] = fe.int_to_limbs(2)
    return tab


def base_niels_affine() -> List[Tuple[int, int, int]]:
    """(y+x, y-x, 2d·x·y) mod p of k*B for k=0..15, as Python ints — the
    fixed-base table in a form any limb radix can encode (the CUDA kernel
    takes it in its own radix; its Z component is the constant 2)."""
    out = []
    pt = ref.IDENT
    B = ref.base_point()
    for _ in range(16):
        x, y, z, t = pt
        zinv = ref.fe_inv(z)
        xa, ya = x * zinv % ref.P, y * zinv % ref.P
        ta = xa * ya % ref.P
        out.append(((ya + xa) % ref.P, (ya - xa) % ref.P, ta * D2 % ref.P))
        pt = ref.point_add(pt, B)
    return out


_BASE_TABLE = torch.from_numpy(_base_niels_table_np())  # (4, 16, 20)


def _select_base(nib):
    """nib (N,) -> niels tuple of (20, N) from the static base table."""
    tab = fe.to_device(_BASE_TABLE, nib.device)
    comps = tab[:, nib.long(), :].permute(0, 2, 1)  # (4, 20, N)
    return (comps[0], comps[1], comps[2], comps[3])


def _select_dyn(table, nib):
    """table: tuple of 4 arrays (20, entries, N); nib (N,)."""
    idx = nib.long()[None, None, :].expand(fe.LIMBS, 1, nib.shape[0])
    return tuple(torch.gather(t, 1, idx)[:, 0] for t in table)


def _negate_niels_where(n, neg):
    """Niels entry n, negated on the lanes where ``neg`` (N,) holds:
    -(x, y) = (-x, y) swaps y+x and y-x and negates 2d·t; 2z stays."""
    ypx, ymx, t2d, z2 = n
    m = neg[None]
    return (torch.where(m, ymx, ypx), torch.where(m, ypx, ymx),
            torch.where(m, fe.neg(t2d), t2d), z2)


def _select_base_signed(d):
    """d (N,) in [-8, 7] -> niels of d·B: entry |d| of the base table,
    negated where d < 0."""
    return _negate_niels_where(_select_base(d.abs()), d < 0)


def _select_dyn_signed(table, d):
    """d (N,) in [-8, 7] -> niels of d·(-A) from the k = 0..8 table."""
    return _negate_niels_where(_select_dyn(table, d.abs()), d < 0)


def _recode_signed(nibs):
    """(64, N) little-endian nibbles in [0, 16) -> digits in [-8, 7] of the
    same scalar (the JAX kernel's loop, ``ed25519_pallas.py:138-145``):
    d = nib + carry; carry = d >= 8; d -= carry << 4.  The carry out of
    window 63 is dropped, so the digits sum to v - c64·2^256, where c64 is
    1 iff v >= 2^256 - 0x88…88 = 0x77…78 (about 2^254.9): v itself for
    every gated s and every h mod L, both < L < 2^253."""
    out = torch.empty_like(nibs)
    carry = torch.zeros_like(nibs[0])
    for t in range(WINDOWS):
        d = nibs[t] + carry
        carry = (d >= 8).to(nibs.dtype)
        out[t] = d - (carry << 4)
    return out


def _build_a_table(neg_a, entries: int = 16):
    """niels table of k*(-A) for k=0..entries-1: tuple of 4 arrays
    (20, entries, N).

    Sequential adds, then the niels conversion vectorized across all the
    entries at once (fe ops are shape-polymorphic in the trailing dims)."""
    n = neg_a[0].shape[1]
    ident = point_identity(n, device=neg_a[0].device)
    mults = [ident]
    p = ident
    for _ in range(entries - 1):
        p = point_add(p, neg_a)
        mults.append(p)
    full = tuple(torch.stack([m[c] for m in mults], dim=1) for c in range(4))
    return to_niels(full)  # each (20, entries, N)


# ---------------------------------------------------------------------------
# the verify kernel (plain PyTorch version of csrc/ed25519_verify.cu)
# ---------------------------------------------------------------------------


def verify_kernel(a_bytes, r_bytes, s_nibs, h_nibs, signed=False):
    """All-device batched check R' == R.

    a_bytes   (32,N) int32 — public key A bytes (little-endian, sign bit 255)
    r_bytes   (32,N) int32 — signature R bytes (to compare against)
    s_nibs    (64,N) int32 — s scalar nibbles, little-endian
    h_nibs    (64,N) int32 — h = SHA512(R‖A‖M) mod L nibbles, little-endian
    signed    the signed-digit windows of ``verify_kernel_pallas(signed=
              True)``: both scalars recoded to [-8, 7] (``_recode_signed``,
              which drops the carry out of window 63), tables of k = 0..8
    returns   (N,) bool
    """
    a_sign = a_bytes[31] >> 7
    a_masked = torch.cat([a_bytes[:31], (a_bytes[31] & 0x7F)[None]], dim=0)
    a_y_limbs = fe.limbs_from_bytes(a_masked)
    a_pt, fail = decompress(a_y_limbs, a_sign)
    neg_a = point_negate(a_pt)
    if signed:
        a_table = _build_a_table(neg_a, SIGNED_ENTRIES)
        s_nibs, h_nibs = _recode_signed(s_nibs), _recode_signed(h_nibs)
        sel_base, sel_dyn = _select_base_signed, _select_dyn_signed
    else:
        a_table = _build_a_table(neg_a)
        sel_base, sel_dyn = _select_base, _select_dyn

    acc = point_identity(a_bytes.shape[1], device=a_bytes.device)
    for i in range(WINDOWS):
        t = WINDOWS - 1 - i
        for k in range(4):
            # only the last double feeds an addition, which is the sole
            # consumer of T — the first three skip the E·H multiply
            acc = point_double(acc, need_t=(k == 3))
        acc = point_add_niels(acc, sel_base(s_nibs[t]))
        # the next consumer is the following window's doubling: no T needed
        acc = point_add_niels(acc, sel_dyn(a_table, h_nibs[t]), need_t=False)
    enc = compress(acc)
    match = torch.all(enc == r_bytes, dim=0)
    return match & ~fail


def _nibbles(b):
    """(32, N) byte rows -> (64, N) int32 little-endian nibbles."""
    b = b.to(torch.int32)
    return torch.stack([b & 0x0F, b >> 4], dim=1).reshape(64, -1)


# calls of the plain packed version, on any device — a run that must go
# through the CUDA kernel reads this to show that it did not come here
plain_calls = 0
_plain_lock = threading.Lock()


def _verify_packed(p, signed=None):
    """verify_kernel over the packed (128, N) uint8 staging layout
    (rows 0:32 A, 32:64 R, 64:96 s, 96:128 h) -> (N,) bool.  ``signed``
    None reads ``_SIGNED_WIN``."""
    global plain_calls
    with _plain_lock:
        plain_calls += 1
    a = p[0:32].to(torch.int32)
    r = p[32:64].to(torch.int32)
    return verify_kernel(a, r, _nibbles(p[64:96]), _nibbles(p[96:128]),
                         signed=_SIGNED_WIN if signed is None else signed)


def _verify_packed_device_hash(p, signed=None):
    """The device-hash pair over the packed (160, N) uint8 layout
    (``ops/sha512.py``): h = SHA-512(R‖A‖M) mod L from the raw rows (flag=0
    lanes keep their host h), then verify_kernel -> (N,) bool."""
    global plain_calls
    with _plain_lock:
        plain_calls += 1
    h = sha512.h_rows_from_packed(p)
    a = p[0:32].to(torch.int32)
    r = p[32:64].to(torch.int32)
    return verify_kernel(a, r, _nibbles(p[64:96]), _nibbles(h),
                         signed=_SIGNED_WIN if signed is None else signed)


# ---------------------------------------------------------------------------
# the verify plane: chunking, host stage, pipelined dispatch, drain
# ---------------------------------------------------------------------------

# sign-masked small-order encodings for the native gate (identical table
# to the Python gate's — both derive from ref25519.small_order_blacklist)
_BLACKLIST = b"".join(ref.small_order_blacklist())
ROWS = 128  # packed staging rows: A, R, s, h
# the C stage's parts between its five clock stamps (sighash.c stage()):
# GIL held, GIL released, the wait to take it back, GIL held
_STAGE_SPANS = ("ed25519.stage_prologue", "ed25519.stage_compute",
                "ed25519.stage_gil_wait", "ed25519.stage_epilogue")
# least bucket of a chunk under a mesh (the JAX verifier's default
# ``min_device_batch``); buckets only place the shard boundaries here, as
# nothing is padded to them
_MIN_DEVICE_BATCH = 16


# the staging layouts of a chunk: LAYOUT_COLS, a (128, lanes) tensor with a
# lane a column (A, R, s, h: host hash, torsion); LAYOUT_ROWS, a device-hash
# chunk's (lanes, 160) item-major rows (``sighash.stage_rows``), which the
# card transposes to the (160, lanes) layout of ``ops/sha512.py`` for B2 and B1
LAYOUT_COLS, LAYOUT_ROWS = "cols", "rows"


class _Shard(NamedTuple):
    """One shard's part of a staged chunk."""

    shard: int            # index into the verifier's devices
    lo: int               # its first lane in the chunk
    n: int                # its live lanes
    packed: torch.Tensor  # its upload tensor, in the chunk's layout (pinned for cuda)
    flagged: int          # its lanes with flag 1, the ones B2 hashes (0 in LAYOUT_COLS)


class _Staged(NamedTuple):
    """One staged chunk: a ``_Shard`` for each shard that holds a live
    lane (the one shard without a mesh), plus the host gate verdicts that
    mask the device results at drain time."""

    shards: tuple         # of _Shard
    ok: np.ndarray        # (n,) bool — strict-input gate results
    n: int                # live lanes
    bufs: tuple           # staging-pool tokens, one a shard; released after drain
    layout: str           # LAYOUT_COLS or LAYOUT_ROWS


class _StagingPool:
    """Reusable preallocated staging buffers of ``lanes`` lanes (a chunk's
    ``max_batch``, or a shard's share of it under a mesh): a flat uint8
    tensor of ``rows`` bytes a lane (pinned when the verifier runs on the
    card) of which a chunk of n lanes uses the first rows·n bytes as a
    contiguous (rows, n) view — a 128-row torsion chunk fits in a 160-row
    device-hash buffer — plus a numpy gate-verdict vector.

    A buffer returns to the pool only AFTER its chunk has been drained,
    i.e. after the event recorded behind that chunk's kernel (and its
    non_blocking upload) has completed — an earlier release would let the
    next chunk's host stage overwrite bytes the copy engine is still
    reading.  Pool size is bounded by the pipeline depth (times the shard
    count under a mesh).  Staging never waits for a buffer: a miss
    allocates a fresh one, under an ``ed25519.pool_alloc`` span."""

    def __init__(self, lanes: int, rows: int, pin: bool, tracer):
        self._lanes = lanes
        self._rows = rows
        self._pin = pin
        self._tracer = tracer
        self._free = []
        self._lock = threading.Lock()

    def acquire(self):
        with self._lock:
            if self._free:
                return self._free.pop()
        with self._tracer.span("ed25519.pool_alloc", lanes=self._lanes, pinned=self._pin):
            return (
                torch.empty(self._rows * self._lanes, dtype=torch.uint8, pin_memory=self._pin),
                np.empty(self._lanes, dtype=np.uint8),
            )

    def release(self, bufs) -> None:
        if bufs is None:
            return
        with self._lock:
            self._free.append(bufs)


class BatchVerifier:
    """Chunks a batch into ``max_batch``-lane ranges, stages each through
    the C host stage into a pooled buffer, uploads it and launches the
    verify kernel over exactly its live lanes; host gate verdicts mask the
    device results, so a gate-rejected lane can never report True (and a
    chunk whose lanes ALL fail the gate skips its launch entirely).

    ``device="cuda"`` (the default) runs the hand-written CUDA kernels and
    builds them when the verifier is constructed; ``device="cpu"`` runs the
    plain PyTorch versions on the host.

    ``device_hash`` (default: ``STELLAR_TPU_DEVICE_HASH=1`` in the
    environment, else off) moves h = SHA-512(R‖A‖M) mod L onto the card:
    chunks stage the raw rows item-major (``sighash.stage_rows``, a
    (n, 160) buffer), the card transposes them to the (160, n) layout, and
    the SHA-512 kernel writes h in place ahead of the verify kernel
    whenever a live lane has a single-block message (flag 1; the stage
    counts them).  Verdicts are the same either way.

    The other knobs read the environment as the JAX package's verifier
    does when their argument is None: ``native_hash`` (default
    ``STELLAR_TPU_NATIVE_SIGHASH != "0"``) picks the C host stage, whose
    failed build raises; False pins the Python stage (``_stage_py`` /
    ``_stage_py_raw``, the same bytes).  ``STELLAR_TPU_SIGHASH_THREADS`` is
    the C stage's thread count (junk reads 0, auto).  ``streams``
    (``STELLAR_TPU_VERIFY_STREAMS``, default 1) and ``host_assist``
    (``STELLAR_TPU_HOST_ASSIST``, default 0, junk 0, clamped to [0, 0.9]);
    a host assist above 0 needs libsodium and raises ValueError where it
    does not load.  ``STELLAR_TPU_SIGNED_WINDOWS`` (``_SIGNED_WIN``) picks
    the signed-digit verify kernel at each launch.

    ``mesh`` (``parallel/mesh.py``) shards every chunk over its devices, as
    the JAX package's verifier does: a chunk of n lanes takes a bucket of
    ``_bucket(n)`` lanes (a multiple of the shard count k, which
    ``max_batch`` is rounded up to), and shard j holds the lanes
    ``[j·w, j·w + w)`` of it, w = bucket // k, so the tail shard holds
    fewer live lanes and the shards past the live range (dead shards) hold
    none.  Each shard with a live lane is staged into its own pooled pinned
    buffer, copied to its own device and run there on its own stream (one
    a stager thread and shard), over its live lanes only; its verdicts come
    back into its slice of one pinned host result.  A dead shard, or one
    whose live lanes all fail the gate, launches nothing.  The mesh's
    devices take the place of ``device``.

    ``tracer`` (``NULL_TRACER`` when None) takes ``ed25519.verify`` a call,
    holding ``ed25519.verify_setup`` (up to the first chunk's submit) and
    ``ed25519.stager_join`` (the stager threads' join after the last
    drain), and, a chunk: ``ed25519.stage_queue`` (from the submit to the
    stager's start); ``ed25519.host_hash``, holding ``ed25519.pool_alloc``
    on a pool miss and, on a real clock, the C stage's ``stage_prologue``,
    ``stage_compute``, ``stage_gil_wait`` and ``stage_epilogue`` from its
    clock stamps, with ``stage_glue`` on either side of the call (its
    attributes: ``layout`` and ``flagged``, the lanes B2 hashes);
    ``ed25519.device_dispatch``, holding ``result_alloc`` and ``launch``;
    ``ed25519.drain``, holding ``drain_wait`` and ``drain_copy``."""

    def __init__(
        self,
        max_batch: int = 4096,
        mesh=None,
        device=None,
        streams: Optional[int] = None,
        host_assist: Optional[float] = None,
        native_hash: Optional[bool] = None,
        device_hash: Optional[bool] = None,
        tracer=None,
    ):
        from ..trace import NULL_TRACER
        from . import ed25519_cuda

        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.devices[0]
            if device is not None and torch.device(device).type != self.device.type:
                raise ValueError(
                    f"device {device!r} is not of the mesh's type ({self.device.type})"
                )
        else:
            self.device = resolve_device("cuda" if device is None else device)
        # every bucket splits evenly over the mesh: the granule is the
        # shard count
        self._granule = len(mesh) if mesh is not None else 1
        self.max_batch = max(1, max_batch)
        if self._granule > 1:
            self.max_batch = max(
                self._granule, -(-self.max_batch // self._granule) * self._granule
            )
        if device_hash is None:
            device_hash = os.environ.get("STELLAR_TPU_DEVICE_HASH", "0") == "1"
        self.device_hash = bool(device_hash)
        self._rows = sha512.DH_ROWS if self.device_hash else ROWS
        self._verify_packed = ed25519_cuda.verify_packed
        if self.device.type == "cuda":
            # build now, and make the constant block on every device of the
            # mesh: never inside a dispatch
            for dev in dict.fromkeys(self._devices()):
                ed25519_cuda.prepare(dev)
            if self.device_hash:
                sha512_cuda.load_library()
        # Host stage: the native C extension (gate + batch SHA-512 mod L +
        # packed staging with the GIL released); a failed build raises.
        # native_hash=False (or STELLAR_TPU_NATIVE_SIGHASH=0) pins the
        # Python stage, as in the JAX package.
        if native_hash is None:
            native_hash = os.environ.get("STELLAR_TPU_NATIVE_SIGHASH", "1") != "0"
        self._sighash = None
        if native_hash:
            from .. import native as _native

            self._sighash = _native.load_sighash()
        # the C stage's threads; 0 = auto (it fans out over its pool for
        # large chunks)
        try:
            self._hash_threads = int(os.environ.get("STELLAR_TPU_SIGHASH_THREADS", "0") or 0)
        except ValueError:
            self._hash_threads = 0
        self._pool = _StagingPool(
            self.max_batch // self._granule, self._rows, pin=self.device.type == "cuda",
            tracer=self._tracer,
        )
        if streams is None:
            streams = int(os.environ.get("STELLAR_TPU_VERIFY_STREAMS", "1"))
        if host_assist is None:
            try:
                host_assist = float(os.environ.get("STELLAR_TPU_HOST_ASSIST", "0") or 0.0)
            except ValueError:
                host_assist = 0.0
        # Fraction of each large batch peeled off to a concurrent libsodium
        # loop while device chunks upload/execute; results are identical by
        # construction.  0 disables.
        self.host_assist = min(0.9, max(0.0, host_assist))
        if self.host_assist > 0.0:
            from ..crypto import sodium

            if not sodium.available():
                raise ValueError(
                    f"host_assist={self.host_assist} (STELLAR_TPU_HOST_ASSIST) verifies "
                    "on the host with libsodium, which does not load here"
                )
        # dispatch streams: stager threads that stage+upload+launch chunks
        # concurrently, each on its own CUDA stream (one a shard)
        self.streams = max(1, streams)
        self._local = threading.local()
        self.n_device_calls = 0
        self.n_items = 0
        self.n_gate_rejects = 0
        self.n_host_assist_items = 0
        self.n_torsion_items = 0
        # n_device_calls is bumped from every stager thread
        self._calls_lock = threading.Lock()

    def _devices(self) -> tuple:
        """The device of each shard (the one device without a mesh, which
        is a mesh of one shard)."""
        return self.mesh.devices if self.mesh is not None else (self.device,)

    def _bucket(self, n: int) -> int:
        """Lanes of an n-lane chunk's bucket, as the JAX package computes
        it: ``_MIN_DEVICE_BATCH`` rounded up to the granule, doubled until
        it holds n, capped at ``max_batch``."""
        b = max(_MIN_DEVICE_BATCH, self._granule)
        b = -(-b // self._granule) * self._granule
        while b < n:
            b *= 2
        return min(b, self.max_batch) if n <= self.max_batch else self.max_batch

    def _shard_ranges(self, n: int) -> List[Tuple[int, int, int]]:
        """(shard, first lane, live lanes) of each shard that holds a live
        lane of an n-lane chunk; dead shards are not listed."""
        width = self._bucket(n) // self._granule
        return [
            (k, k * width, min(width, n - k * width))
            for k in range(self._granule)
            if k * width < n
        ]

    def verify(self, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        """items: (pubkey32, msg, sig64) triples -> list of bool.

        Chunks are (start, n) RANGES over ``items``: each chunk's gate +
        hash + staging happens in one C call over the original bytes
        objects (one a shard under a mesh), and gate verdicts mask the
        device results at drain time.  One ``ed25519.verify`` span a call."""
        items = items if isinstance(items, (list, tuple)) else list(items)
        with self._tracer.span("ed25519.verify", items=len(items)):
            return self._verify(items)

    def _verify(self, items) -> List[bool]:
        tracer = self._tracer
        # ed25519.verify_setup: up to the first chunk's submit to the stager
        setup = tracer.begin("ed25519.verify_setup")
        out = [False] * len(items)
        self.n_items += len(items)
        n_dev = len(items)
        # Host-assist: peel the tail of a large batch onto a concurrent
        # libsodium loop (ctypes releases the GIL) so the host core works
        # while device chunks upload/execute.
        assist_join = None
        assist_err: List[BaseException] = []
        if self.host_assist > 0.0 and len(items) >= 4:
            host_n = int(len(items) * self.host_assist)
            if host_n > 0:
                n_dev = len(items) - host_n
                self.n_host_assist_items += host_n
                from ..crypto.sigbackend import _sodium_verify_loop

                def assist(start=n_dev, count=host_n):
                    # a raise here must NOT die silently with the thread:
                    # out[] rows would stay False and valid signatures
                    # would be reported failed — capture and re-raise on
                    # the caller after the join
                    try:
                        with self._tracer.span("ed25519.host_assist", items=count):
                            oks = _sodium_verify_loop(items[start : start + count])
                            for j, ok in enumerate(oks):
                                out[start + j] = ok
                    except BaseException as e:
                        assist_err.append(e)

                _t = threading.Thread(
                    target=assist, name="verify-host-assist", daemon=True
                )
                _t.start()
                assist_join = _t.join
        pending = []

        def drain_one():
            (start, n), staged, fut = pending.pop(0)
            dsp = tracer.begin("ed25519.drain")
            if fut is not None:
                with tracer.span("ed25519.drain_wait"):
                    got = self._collect(fut)
                with tracer.span("ed25519.drain_copy"):
                    res = np.logical_and(got[:n], staged.ok[:n])
                    out[start : start + n] = res.tolist()
            # fut None: every lane was gate-rejected — out[] rows stay
            # False without a device round-trip
            tracer.end(dsp, items=n)
            self._release(staged)

        chunks = [
            (s, min(self.max_batch, n_dev - s))
            for s in range(0, n_dev, self.max_batch)
        ]
        try:
            self._run_pipeline(items, chunks, pending, drain_one, setup=setup)
        finally:
            # join even when the device pipeline raises: an orphan assist
            # thread would compete with the caller's retry for host cores
            if assist_join is not None:
                assist_join()
        if assist_err:
            raise assist_err[0]
        return out

    def verify_torsion(self, encs: Sequence[bytes]) -> List[bool]:
        """Batched prime-order-subgroup proofs on the SAME verify kernel:
        [L]·P == identity is computed AS-IS via verify(A := P, h := L,
        s := 0, R := identity-encoding) — the ladder evaluates
        0·B + L·(−P) and the byte compare against the identity encoding
        passes iff L·P is the identity.  No hash stage runs; under a mesh
        the chunk shards as a verify chunk does.

        A malformed length, non-canonical y, or undecodable encoding
        returns False."""
        encs = encs if isinstance(encs, (list, tuple)) else list(encs)
        out = [False] * len(encs)
        if not encs:
            return out
        self.n_torsion_items += len(encs)
        pending = []

        def drain_one():
            (start, n), staged, fut = pending.pop(0)
            dsp = self._tracer.begin("ed25519.torsion_drain")
            if fut is not None:
                res = np.logical_and(self._collect(fut)[:n], staged.ok[:n])
                out[start : start + n] = res.tolist()
            self._tracer.end(dsp, items=n)
            self._release(staged)

        chunks = [
            (s, min(self.max_batch, len(encs) - s))
            for s in range(0, len(encs), self.max_batch)
        ]
        self._run_pipeline(
            encs, chunks, pending, drain_one, stage_fn=self._stage_torsion
        )
        return out

    def _stage_torsion(self, encs, start, n) -> Optional[_Staged]:
        """Stage a torsion-proof chunk: A column = the encodings, R =
        identity encoding, s = 0, h = L (host-precomputed — no hash)."""
        if n == 0:
            return None
        return self._stage_shards(encs, start, n, LAYOUT_COLS, self._fill_torsion_into)[0]

    def _fill_torsion_into(self, encs, start, n, packed, okbuf) -> Tuple[int, int]:
        self._fill_torsion(encs, start, n, packed.numpy(), okbuf)
        return 0, 0

    @staticmethod
    def _fill_torsion(encs, start, n, packed, okbuf) -> None:
        """numpy fill of one torsion chunk.  The device decompress does
        not re-check y-canonicity (the verify path's host gate does), so
        non-canonical encodings are gated right here to keep parity with
        the strict host decode."""
        packed[:, :] = 0
        ok = np.zeros(n, dtype=bool)
        well = [j for j in range(n) if len(encs[start + j]) == 32]
        if well:
            enc_arr = np.frombuffer(
                b"".join(encs[start + j] for j in well), dtype=np.uint8
            ).reshape(-1, 32)
            # canonical y < 2^255 - 19 (sign bit masked) — the SAME
            # vectorized compare ref.strict_input_ok_batch runs
            enc_m = enc_arr.copy()
            enc_m[:, 31] &= 0x7F
            canon = ref._le_lt(enc_m.view("<u8").reshape(-1, 4), ref.P)
            idx = np.asarray(well, dtype=np.intp)
            ok[idx] = canon
            live = idx[canon]
            packed[0:32, live] = enc_arr[canon].T
        # R := identity encoding (0x01 ‖ 0^31), h := L, on live lanes only
        packed[32, :n] = ok
        packed[96:128, :n] = L_BYTES[:, None] * ok[None, :]
        okbuf[:n] = ok

    def _run_pipeline(self, items, chunks, pending, drain_one, stage_fn=None, setup=None):
        """Stage, dispatch and drain ``chunks`` in order; ``setup``, an open
        span of the caller's, ends where the first chunk is handed on."""
        stage = stage_fn if stage_fn is not None else self._stage_chunk
        if len(chunks) <= 1:
            for rng in chunks:
                self._tracer.end(setup)
                staged = stage(items, *rng)
                pending.append((rng, staged, self._dispatch_staged(staged)))
            while pending:
                drain_one()
        else:
            from concurrent.futures import ThreadPoolExecutor

            # Bound SUBMITTED-but-undrained chunks at `depth`: a queued
            # future can start the moment a worker frees, so the
            # submission count is the device in-flight bound.  The bound
            # lives in a plain main-thread counter, NOT a semaphore
            # acquired on the workers — with streams>1 a later chunk's
            # worker could steal the last permit out of chunk order while
            # the main thread blocks on an earlier chunk's future that
            # can then never dispatch (deadlock).  With >1 streams each
            # needs an in-flight slot plus one being drained.
            depth = max(PIPELINE_DEPTH, self.streams + 1)

            def stage_and_dispatch(rng, queued):
                # ed25519.stage_queue: from the submit to the stager's start
                self._tracer.end(queued)
                staged = stage(items, *rng)
                return staged, self._dispatch_staged(staged)

            stager = ThreadPoolExecutor(max_workers=self.streams)
            futs = []
            drained = 0

            def drain_oldest():
                nonlocal drained
                rng, f = futs[drained]
                drained += 1
                staged, fut = f.result()
                pending.append((rng, staged, fut))
                drain_one()

            try:
                for rng in chunks:
                    if len(futs) - drained >= depth:
                        drain_oldest()
                    self._tracer.end(setup)  # a no-op after the first chunk
                    queued = self._tracer.begin("ed25519.stage_queue")
                    futs.append((rng, stager.submit(stage_and_dispatch, rng, queued)))
                while drained < len(futs):
                    drain_oldest()
            except BaseException:
                # drop queued work; running workers just finish their
                # chunk, so the shutdown below joins cleanly
                for _, f in futs:
                    f.cancel()
                raise
            finally:
                # the stager threads live for one call: their join
                with self._tracer.span("ed25519.stager_join"):
                    stager.shutdown(wait=True)

    def _stage_chunk(self, items, start, n) -> Optional[_Staged]:
        """Host stage over ``items[start:start+n]``: strict-input gate +
        h = SHA-512(R‖A‖M) mod L + the packed transposed (128, n) upload
        layout, written straight into a pooled (pinned) buffer.  With
        device_hash: gate + the raw rows item-major, (n, 160), hashing only
        messages longer than one block (``stage_rows``).  One such pass a
        shard, into the shard's own buffer: the chunk is never repacked on
        the host."""
        if n == 0:
            return None
        sp = self._tracer.begin("ed25519.host_hash")
        layout = LAYOUT_ROWS if self.device_hash else LAYOUT_COLS
        staged, rejects = self._stage_shards(items, start, n, layout, self._stage_into)
        self._tracer.end(sp, items=n, rejects=rejects, device_hash=self.device_hash,
                         layout=layout, flagged=sum(sh.flagged for sh in staged.shards))
        if rejects:
            with self._calls_lock:  # stager threads update concurrently
                self.n_gate_rejects += int(rejects)
        return staged

    def _stage_into(self, items, start, n, packed, okbuf) -> Tuple[int, int]:
        """One host-stage pass into a pooled view, (n, 160) item-major with
        device_hash, else (128, n): the C stage (GIL released) unless
        ``native_hash`` pinned the Python one; returns the gate's rejects
        and the lanes with flag 1."""
        if self._sighash is None:
            if not self.device_hash:
                return self._stage_py(items, start, n, packed.numpy(), okbuf), 0
            rows = packed.numpy()
            # the (160, n) layout's writes land item-major through the view
            rejects = self._stage_py_raw(items, start, n, rows.T, okbuf)
            return rejects, int(np.count_nonzero(rows[:, sha512.ROW_FLAG]))
        # stage_rows returns (rejects, flagged), stage the rejects alone
        stage = self._sighash.stage_rows if self.device_hash else self._sighash.stage
        tracer = self._tracer
        if not (tracer.enabled and tracer.real_clock):
            res = stage(items, start, n, packed.numpy(), okbuf, _BLACKLIST, self._hash_threads)
        else:
            # the C stage's clock stamps (CLOCK_MONOTONIC ns, the tracer's
            # clock): four children of ed25519.host_hash, and
            # ed25519.stage_glue for this frame's Python on either side of
            # the call
            entered = time.monotonic()
            stamps = np.zeros(len(_STAGE_SPANS) + 1, dtype=np.uint64)
            res = stage(items, start, n, packed.numpy(), okbuf, _BLACKLIST,
                        self._hash_threads, stamps)
            t = (stamps / 1e9).tolist()
            tracer.record("ed25519.stage_glue", entered, t[0])
            for k, name in enumerate(_STAGE_SPANS):
                tracer.record(name, t[k], t[k + 1], items=n)
            tracer.record("ed25519.stage_glue", t[-1], time.monotonic())
        return res if self.device_hash else (res, 0)

    @staticmethod
    def _gate_chunk(items, start, n, packed, okbuf, keep_rejected):
        """The Python stage's common part: zero the (rows, n) view, run the
        strict gate over the well-formed triples, and write A, R and s of
        each lane that passes — and, with ``keep_rejected``, of each
        well-formed lane that does not, as ``sighash.stage`` does.  Returns
        the (lane, pk, msg, sig) of the lanes that pass; ``okbuf`` holds
        the verdicts."""
        chunk = [items[start + j] for j in range(n)]
        ok = np.zeros(n, dtype=bool)
        well = [j for j, it in enumerate(chunk) if len(it[-3]) == 32 and len(it[-1]) == 64]
        packed[:, :n] = 0
        passed = []
        if well:
            pk_arr = np.frombuffer(b"".join(chunk[j][-3] for j in well), dtype=np.uint8).reshape(-1, 32)
            sig_arr = np.frombuffer(b"".join(chunk[j][-1] for j in well), dtype=np.uint8).reshape(-1, 64)
            gate = ref.strict_input_ok_batch(pk_arr, sig_arr)
            for k, j in enumerate(well):
                if not (gate[k] or keep_rejected):
                    continue
                packed[0:32, j] = pk_arr[k]
                packed[32:64, j] = sig_arr[k, :32]
                packed[64:96, j] = sig_arr[k, 32:]
                if gate[k]:
                    ok[j] = True
                    passed.append((j, *chunk[j][-3:]))
        okbuf[:n] = ok
        return passed

    @staticmethod
    def _h_bytes(pk, msg, sig) -> np.ndarray:
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
        return np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)

    @classmethod
    def _stage_py(cls, items, start, n, packed, okbuf) -> int:
        """Pure-Python host stage (hashlib + the vectorized numpy gate)
        filling the (128, n) layout byte for byte as ``sighash.stage``
        does: the JAX package's ``_stage_py``, except that a gate-rejected
        lane keeps its A, R and s there as in the C stage (its h is 0, and
        the gate masks its verdict)."""
        passed = cls._gate_chunk(items, start, n, packed, okbuf, keep_rejected=True)
        for j, pk, msg, sig in passed:
            packed[96:128, j] = cls._h_bytes(pk, msg, sig)
        return n - len(passed)

    @classmethod
    def _stage_py_raw(cls, items, start, n, packed, okbuf) -> int:
        """Pure-Python device-hash staging filling the (160, n) raw layout
        as ``sighash.stage_raw`` does: a single-block message uploads raw
        with its length and flag 1, a longer one is hashed here (hashlib)
        with flag 0 (the JAX package's ``_stage_py_raw``); a gate-rejected
        lane stays all zero.  ``packed`` may be a view: the transpose of an
        (n, 160) buffer takes ``sighash.stage_rows``' bytes."""
        passed = cls._gate_chunk(items, start, n, packed, okbuf, keep_rejected=False)
        for j, pk, msg, sig in passed:
            if len(msg) <= sha512.MAX_DEVICE_MSG:
                if msg:
                    packed[96 : 96 + len(msg), j] = np.frombuffer(msg, dtype=np.uint8)
                packed[sha512.ROW_MLEN, j] = len(msg)
                packed[sha512.ROW_FLAG, j] = 1
            else:
                packed[96:128, j] = cls._h_bytes(pk, msg, sig)
        return n - len(passed)

    def _stage_shards(self, items, start, n, layout, fill) -> Tuple[_Staged, int]:
        """Staging -> (the staged chunk, the gate's rejects): each shard
        with a live lane gets its own pooled buffer, filled by ``fill`` over
        the shard's live range only (a view of its live lanes in
        ``layout``: (lanes, 160) or (128, lanes)); ``fill`` returns its
        rejects and flag-1 lanes.  Live lanes lie shard-major over the
        bucket, so the tail shard is short and dead shards stage nothing;
        without a mesh the one shard is the chunk."""
        shards, bufs = [], []
        ok = np.zeros(n, dtype=bool)
        rejects = 0
        for k, lo, cnt in self._shard_ranges(n):
            buf = self._pool.acquire()
            bufs.append(buf)
            if layout == LAYOUT_ROWS:
                packed = buf[0][: sha512.DH_ROWS * cnt].view(cnt, sha512.DH_ROWS)
            else:
                packed = buf[0][: ROWS * cnt].view(ROWS, cnt)
            rej, flagged = fill(items, start + lo, cnt, packed, buf[1])
            rejects += rej
            ok[lo : lo + cnt] = buf[1][:cnt].astype(bool)
            shards.append(_Shard(k, lo, cnt, packed, flagged))
        return _Staged(tuple(shards), ok, n, tuple(bufs), layout), rejects

    def _release(self, staged: Optional[_Staged]) -> None:
        if staged is None:
            return
        for bufs in staged.bufs:
            self._pool.release(bufs)

    def _stream(self, shard: int = 0):
        """This thread's CUDA stream for ``shard`` (on the shard's device):
        each stager thread launches on its own, so with streams > 1 one
        chunk's upload overlaps another's kernel, and each shard has its
        own, so shards overlap even when a mesh names one device twice."""
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        s = streams.get(shard)
        if s is None:
            s = streams[shard] = torch.cuda.Stream(self._devices()[shard])
        return s

    def _run_kernels(self, packed: torch.Tensor, device: torch.device,
                     layout: str = LAYOUT_COLS, flagged: int = 0) -> torch.Tensor:
        """One staged host tensor through the kernels on ``device`` ->
        (n,) bool verdicts.  On the card: ONE copy to the device, then, for
        a device-hash chunk (LAYOUT_ROWS), the transpose into the (160, n)
        layout and the SHA-512 kernel in place when the host stage counted
        ``flagged`` lanes with flag 1 (an all-flag-0 chunk skips the
        launch), and the verify kernel over the first 128 rows — all on the
        current device and stream."""
        if device.type != "cuda":
            if layout == LAYOUT_ROWS:
                return _verify_packed_device_hash(sha512_cuda.rows_to_cols(packed))
            return self._verify_packed(packed)
        dev = packed.to(device, non_blocking=True)
        if layout == LAYOUT_ROWS:
            dev = sha512_cuda.rows_to_cols(dev)
            if flagged:
                sha512_cuda.hash_in_place(dev)
            dev = dev[:ROWS]
        return self._verify_packed(dev)

    def _dispatch_staged(self, staged: Optional[_Staged]):
        """Upload the staged chunk and launch the kernel(s): for each shard
        with a live, gate-passing lane, one copy and one launch of each
        kernel, on the shard's device and stream.  Returns the in-flight
        result — a (host result, [events]) pair, the events empty on the
        CPU — or None when every lane was gate-rejected (hostile floods
        never reach the chip)."""
        if staged is None or not staged.ok.any():
            return None
        dsp = self._tracer.begin("ed25519.device_dispatch")
        cuda = self.device.type == "cuda"
        parts = tuple(sh for sh in staged.shards if staged.ok[sh.lo : sh.lo + sh.n].any())
        # one host result for the chunk; the lanes of a shard that launched
        # nothing are all gate-rejected, and the drain masks them False
        with self._tracer.span("ed25519.result_alloc"):
            host = torch.empty(staged.n, dtype=torch.bool, pin_memory=cuda)
        events = []
        with self._tracer.span("ed25519.launch", shards=len(parts)):
            for k, lo, cnt, packed, flagged in parts:
                dev = self._devices()[k]
                out = host[lo : lo + cnt]
                if not cuda:
                    out.copy_(self._run_kernels(packed, dev, staged.layout, flagged))
                    continue
                stream = self._stream(k)
                # the stream makes its device current; the wrappers make the
                # tensor's device current around each launch
                with torch.cuda.stream(stream):
                    out.copy_(self._run_kernels(packed, dev, staged.layout, flagged),
                              non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                events.append(done)
        self._tracer.end(dsp, lanes=staged.n, shards=len(parts), device=str(self.device))
        with self._calls_lock:
            self.n_device_calls += 1
        return host, events

    @staticmethod
    def _collect(fut) -> np.ndarray:
        """Wait for a dispatched chunk (its events, one a launched shard,
        cover the uploads, the kernels and the copies back) and return its
        verdicts."""
        res, events = fut
        for done in events:
            done.synchronize()
        return res.numpy()

    def stats(self) -> dict:
        return {
            "backend": "gpu",
            "device_calls": self.n_device_calls,
            "items": self.n_items,
            "gate_rejects": self.n_gate_rejects,
            "host_assist_items": self.n_host_assist_items,
            "native_host_stage": self._sighash is not None,
            "device_hash": self.device_hash,
            "torsion_items": self.n_torsion_items,
            # 0 = unsharded; >0 = shards of the mesh (Config.SIG_MESH)
            "mesh_devices": len(self.mesh) if self.mesh is not None else 0,
        }
