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
    """table: tuple of 4 arrays (20, 16, N); nib (N,)."""
    idx = nib.long()[None, None, :].expand(fe.LIMBS, 1, nib.shape[0])
    return tuple(torch.gather(t, 1, idx)[:, 0] for t in table)


def _build_a_table(neg_a):
    """niels table of k*(-A) for k=0..15: tuple of 4 arrays (20, 16, N).

    Sequential adds, then the niels conversion vectorized across all 16
    entries at once (fe ops are shape-polymorphic in the trailing dims)."""
    n = neg_a[0].shape[1]
    ident = point_identity(n, device=neg_a[0].device)
    mults = [ident]
    p = ident
    for _ in range(15):
        p = point_add(p, neg_a)
        mults.append(p)
    full = tuple(torch.stack([m[c] for m in mults], dim=1) for c in range(4))
    return to_niels(full)  # each (20, 16, N)


# ---------------------------------------------------------------------------
# the verify kernel (plain PyTorch version of csrc/ed25519_verify.cu)
# ---------------------------------------------------------------------------


def verify_kernel(a_bytes, r_bytes, s_nibs, h_nibs):
    """All-device batched check R' == R.

    a_bytes   (32,N) int32 — public key A bytes (little-endian, sign bit 255)
    r_bytes   (32,N) int32 — signature R bytes (to compare against)
    s_nibs    (64,N) int32 — s scalar nibbles, little-endian
    h_nibs    (64,N) int32 — h = SHA512(R‖A‖M) mod L nibbles, little-endian
    returns   (N,) bool
    """
    a_sign = a_bytes[31] >> 7
    a_masked = torch.cat([a_bytes[:31], (a_bytes[31] & 0x7F)[None]], dim=0)
    a_y_limbs = fe.limbs_from_bytes(a_masked)
    a_pt, fail = decompress(a_y_limbs, a_sign)
    neg_a = point_negate(a_pt)
    a_table = _build_a_table(neg_a)

    acc = point_identity(a_bytes.shape[1], device=a_bytes.device)
    for i in range(WINDOWS):
        t = WINDOWS - 1 - i
        for k in range(4):
            # only the last double feeds an addition, which is the sole
            # consumer of T — the first three skip the E·H multiply
            acc = point_double(acc, need_t=(k == 3))
        acc = point_add_niels(acc, _select_base(s_nibs[t]))
        # the next consumer is the following window's doubling: no T needed
        acc = point_add_niels(acc, _select_dyn(a_table, h_nibs[t]), need_t=False)
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


def _verify_packed(p):
    """verify_kernel over the packed (128, N) uint8 staging layout
    (rows 0:32 A, 32:64 R, 64:96 s, 96:128 h) -> (N,) bool."""
    global plain_calls
    with _plain_lock:
        plain_calls += 1
    a = p[0:32].to(torch.int32)
    r = p[32:64].to(torch.int32)
    return verify_kernel(a, r, _nibbles(p[64:96]), _nibbles(p[96:128]))


def _verify_packed_device_hash(p):
    """The device-hash pair over the packed (160, N) uint8 layout
    (``ops/sha512.py``): h = SHA-512(R‖A‖M) mod L from the raw rows (flag=0
    lanes keep their host h), then verify_kernel -> (N,) bool."""
    global plain_calls
    with _plain_lock:
        plain_calls += 1
    h = sha512.h_rows_from_packed(p)
    a = p[0:32].to(torch.int32)
    r = p[32:64].to(torch.int32)
    return verify_kernel(a, r, _nibbles(p[64:96]), _nibbles(h))


# ---------------------------------------------------------------------------
# the verify plane: chunking, host stage, pipelined dispatch, drain
# ---------------------------------------------------------------------------

# sign-masked small-order encodings for the native gate (identical table
# to the Python gate's — both derive from ref25519.small_order_blacklist)
_BLACKLIST = b"".join(ref.small_order_blacklist())
ROWS = 128  # packed staging rows: A, R, s, h


class _Staged(NamedTuple):
    """One staged chunk: the packed ``(128, n)`` upload tensor (``(160, n)``
    for a device-hash verify chunk) plus the host gate verdicts that mask
    the device results at drain time."""

    packed: torch.Tensor  # (rows, n) uint8, contiguous (pinned for cuda)
    ok: np.ndarray        # (n,) bool — strict-input gate results
    n: int                # live lanes
    bufs: tuple           # staging-pool token; released after drain


class _StagingPool:
    """Reusable preallocated staging buffers of ``max_batch`` lanes: a flat
    uint8 tensor of ``rows`` bytes a lane (pinned when the verifier runs on
    the card) of which a chunk of n lanes uses the first rows·n bytes as a
    contiguous (rows, n) view — a 128-row torsion chunk fits in a 160-row
    device-hash buffer — plus a numpy gate-verdict vector.

    A buffer returns to the pool only AFTER its chunk has been drained,
    i.e. after the event recorded behind that chunk's kernel (and its
    non_blocking upload) has completed — an earlier release would let the
    next chunk's host stage overwrite bytes the copy engine is still
    reading.  Pool size is bounded by the pipeline depth."""

    def __init__(self, lanes: int, rows: int, pin: bool):
        self._lanes = lanes
        self._rows = rows
        self._pin = pin
        self._free = []
        self._lock = threading.Lock()

    def acquire(self):
        with self._lock:
            if self._free:
                return self._free.pop()
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
    chunks stage the (160, n) raw layout (``sighash.stage_raw``), and the
    SHA-512 kernel writes h in place ahead of the verify kernel whenever a
    live lane has a single-block message (flag 1).  Verdicts are the same
    either way."""

    def __init__(
        self,
        max_batch: int = 4096,
        device="cuda",
        streams: int = 1,
        host_assist: float = 0.0,
        device_hash: Optional[bool] = None,
        tracer=None,
    ):
        from ..trace import NULL_TRACER
        from . import ed25519_cuda

        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.device = resolve_device(device)
        self.max_batch = max(1, max_batch)
        if device_hash is None:
            device_hash = os.environ.get("STELLAR_TPU_DEVICE_HASH", "0") == "1"
        self.device_hash = bool(device_hash)
        self._rows = sha512.DH_ROWS if self.device_hash else ROWS
        self._verify_packed = ed25519_cuda.verify_packed
        if self.device.type == "cuda":
            # build now, never inside a dispatch
            ed25519_cuda.load_library()
            if self.device_hash:
                sha512_cuda.load_library()
        # Host stage: the native C extension (gate + batch SHA-512 mod L +
        # packed staging with the GIL released); a failed build raises
        from .. import native as _native

        self._sighash = _native.load_sighash()
        self._pool = _StagingPool(self.max_batch, self._rows, pin=self.device.type == "cuda")
        # Fraction of each large batch peeled off to a concurrent libsodium
        # loop while device chunks upload/execute; results are identical by
        # construction.  0 disables.
        self.host_assist = min(0.9, max(0.0, host_assist))
        # dispatch streams: stager threads that stage+upload+launch chunks
        # concurrently, each on its own CUDA stream
        self.streams = max(1, streams)
        self._local = threading.local()
        self.n_device_calls = 0
        self.n_items = 0
        self.n_gate_rejects = 0
        self.n_host_assist_items = 0
        self.n_torsion_items = 0
        self.verify_seconds = 0.0
        # n_device_calls is bumped from every stager thread
        self._calls_lock = threading.Lock()

    def verify(self, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        """items: (pubkey32, msg, sig64) triples -> list of bool.

        Chunks are (start, n) RANGES over ``items``: each chunk's gate +
        hash + staging happens in one C call over the original bytes
        objects, and gate verdicts mask the device results at drain time."""
        items = items if isinstance(items, (list, tuple)) else list(items)
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
        t0 = time.perf_counter()

        def drain_one():
            (start, n), staged, fut = pending.pop(0)
            dsp = self._tracer.begin("ed25519.drain")
            if fut is not None:
                res = np.logical_and(self._collect(fut)[:n], staged.ok[:n])
                out[start : start + n] = res.tolist()
            # fut None: every lane was gate-rejected — out[] rows stay
            # False without a device round-trip
            self._tracer.end(dsp, items=n)
            if staged is not None:
                self._pool.release(staged.bufs)

        chunks = [
            (s, min(self.max_batch, n_dev - s))
            for s in range(0, n_dev, self.max_batch)
        ]
        try:
            self._run_pipeline(items, chunks, pending, drain_one)
        finally:
            # join even when the device pipeline raises: an orphan assist
            # thread would compete with the caller's retry for host cores
            if assist_join is not None:
                assist_join()
        if assist_err:
            raise assist_err[0]
        # wall time of the whole batched call: staging + hashing + device
        # compute + sync (NOT device-only)
        self.verify_seconds += time.perf_counter() - t0
        return out

    def verify_torsion(self, encs: Sequence[bytes]) -> List[bool]:
        """Batched prime-order-subgroup proofs on the SAME verify kernel:
        [L]·P == identity is computed AS-IS via verify(A := P, h := L,
        s := 0, R := identity-encoding) — the ladder evaluates
        0·B + L·(−P) and the byte compare against the identity encoding
        passes iff L·P is the identity.  No hash stage runs.

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
            if staged is not None:
                self._pool.release(staged.bufs)

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
        bufs = self._pool.acquire()
        packed = bufs[0][: ROWS * n].view(ROWS, n)
        self._fill_torsion(encs, start, n, packed.numpy(), bufs[1])
        return _Staged(packed, bufs[1][:n].astype(bool), n, bufs)

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

    def _run_pipeline(self, items, chunks, pending, drain_one, stage_fn=None):
        stage = stage_fn if stage_fn is not None else self._stage_chunk
        if len(chunks) <= 1:
            for rng in chunks:
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

            def stage_and_dispatch(rng):
                staged = stage(items, *rng)
                return staged, self._dispatch_staged(staged)

            with ThreadPoolExecutor(max_workers=self.streams) as stager:
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
                        futs.append((rng, stager.submit(stage_and_dispatch, rng)))
                    while drained < len(futs):
                        drain_oldest()
                except BaseException:
                    # drop queued work; running workers just finish their
                    # chunk, so executor __exit__ joins cleanly
                    for _, f in futs:
                        f.cancel()
                    raise

    def _stage_chunk(self, items, start, n) -> Optional[_Staged]:
        """Host stage over ``items[start:start+n]``: strict-input gate +
        h = SHA-512(R‖A‖M) mod L + the packed transposed (128, n) upload
        layout, written straight into a pooled (pinned) buffer.  With
        device_hash: gate + the raw (160, n) layout, hashing only messages
        longer than one block (``stage_raw``)."""
        if n == 0:
            return None
        bufs = self._pool.acquire()
        packed = bufs[0][: self._rows * n].view(self._rows, n)
        stage = self._sighash.stage_raw if self.device_hash else self._sighash.stage
        sp = self._tracer.begin("ed25519.host_hash")
        rejects = stage(items, start, n, packed.numpy(), bufs[1], _BLACKLIST, 0)
        self._tracer.end(sp, items=n, rejects=rejects, device_hash=self.device_hash)
        if rejects:
            with self._calls_lock:  # stager threads update concurrently
                self.n_gate_rejects += int(rejects)
        return _Staged(packed, bufs[1][:n].astype(bool), n, bufs)

    def _stream(self):
        """This thread's CUDA stream: each stager thread launches on its
        own, so with streams > 1 one chunk's upload overlaps another's
        kernel."""
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return s

    def _dispatch_staged(self, staged: Optional[_Staged]):
        """Upload the packed staging tensor (ONE transfer) and launch the
        kernel(s).  A device-hash chunk launches the SHA-512 kernel first,
        in place, when a lane has flag 1 — the host reads the flag row of
        its own staging buffer, so an all-flag-0 chunk skips the launch —
        and the verify kernel then reads the first 128 rows.  Returns the
        in-flight result — on the card a (pinned host result, event) pair —
        or None when every lane was gate-rejected (hostile floods never
        reach the chip)."""
        if staged is None or not staged.ok.any():
            return None
        dsp = self._tracer.begin("ed25519.device_dispatch")
        device_hash = staged.packed.shape[0] == sha512.DH_ROWS
        if self.device.type == "cuda":
            stream = self._stream()
            with torch.cuda.stream(stream):
                dev = staged.packed.to(self.device, non_blocking=True)
                if device_hash:
                    if staged.packed[sha512.ROW_FLAG].numpy().any():
                        sha512_cuda.hash_in_place(dev)
                    dev = dev[:ROWS]
                res = self._verify_packed(dev)
                host = torch.empty(res.shape, dtype=torch.bool, pin_memory=True)
                host.copy_(res, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            fut = (host, done)
        elif device_hash:
            fut = (_verify_packed_device_hash(staged.packed), None)
        else:
            fut = (self._verify_packed(staged.packed), None)
        self._tracer.end(dsp, lanes=staged.packed.shape[1], device=str(self.device))
        with self._calls_lock:
            self.n_device_calls += 1
        return fut

    @staticmethod
    def _collect(fut) -> np.ndarray:
        """Wait for a dispatched chunk (its event covers the upload, the
        kernel and the copy back) and return its verdicts."""
        res, done = fut
        if done is not None:
            done.synchronize()
        return res.numpy()

    def stats(self) -> dict:
        return {
            "backend": "gpu",
            "device_calls": self.n_device_calls,
            "items": self.n_items,
            "gate_rejects": self.n_gate_rejects,
            "host_assist_items": self.n_host_assist_items,
            "native_host_stage": True,
            "device_hash": self.device_hash,
            "torsion_items": self.n_torsion_items,
            "verify_seconds": self.verify_seconds,
            "mesh_devices": 0,
        }
