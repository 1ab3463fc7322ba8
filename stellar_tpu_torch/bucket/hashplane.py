"""State-plane hash pipeline: batched per-record bucket hashing behind a
backend seam, on the card.

A copy of the JAX package's ``bucket/hashplane.py``.  The v2 bucket content
hash is

    H(bucket) = SHA256( d_1 ‖ d_2 ‖ … ‖ d_n ),   d_i = SHA256(frame_i)

where ``frame_i`` is the full i-th record as written (4-byte RFC 5531
header ‖ XDR body).  The per-record digests are an embarrassingly parallel
batch (the kernel's lanes, the C pool's tiles); the sequential combine
touches 32 bytes per record.  The empty stream hashes to SHA256(b"").

Three backends, all bit-identical (pinned by tests/test_torch_hashplane.py
against the JAX package's):

- ``device``  — the batched multi-block SHA-256 kernel
  (``csrc/sha256_frames.cu`` via ``ops/sha256_cuda.py``; on
  ``device="cpu"`` its plain PyTorch version), knob ``DEVICE_BUCKET_HASH``.
  Frames are size-classed into power-of-two ``max_blocks`` shapes; frames
  above ``DEVICE_MAX_BLOCKS`` compression blocks spill to hashlib — same
  digests, merged in order.
- ``native``  — ``native/sighash.c``'s ``sha256_batch`` /
  ``bucket_hash_frames``: GIL-released, tile-fanned over the pthread pool;
  a bucket file is hashed in one C pass by ``bucketmerge.c``
  (``native.bucket_hash_v2_file``).  The default whenever the extension
  builds.
- ``hashlib`` — the always-available last resort (and the differential
  oracle), forced by ``STELLAR_TPU_NO_NATIVE_HASH=1``.

One difference from the JAX package, on purpose: **no silent fallback
from the device.**  With ``DEVICE_BUCKET_HASH`` on, ``get_backend`` builds
the device backend on the config's ``SIG_DEVICE`` ("cuda" unless set) and
raises without CUDA; the JAX package falls through to the native backend.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import resolve_device, sha256, sha256_cuda
from ..trace import NULL_TRACER

_MAX_FRAME = 64 << 20  # the XDR stream's body cap
_FLUSH_BYTES = 4 << 20  # BucketHasher batches this much before digesting
DEVICE_MAX_BLOCKS = 64  # frames above 64 SHA blocks (~4 KB) skip the device


def split_frames(buf) -> List[bytes]:
    """A framed record buffer -> the list of full frames (header+body).
    Raises ValueError on a truncated/malformed frame."""
    frames = []
    view = memoryview(buf)
    off, n = 0, len(view)
    while off < n:
        if off + 4 > n:
            raise ValueError("truncated bucket frame header")
        (hdr,) = struct.unpack_from(">I", view, off)
        if not hdr & 0x80000000:
            raise ValueError("bucket frame missing continuation bit")
        ln = hdr & 0x7FFFFFFF
        if ln > _MAX_FRAME:
            raise ValueError("oversized bucket frame")
        end = off + 4 + ln
        if end > n:
            raise ValueError("truncated bucket frame body")
        frames.append(bytes(view[off:end]))
        off = end
    return frames


def size_classes(nblocks) -> List[Tuple[int, np.ndarray]]:
    """The device backend's launches over frames of ``nblocks`` SHA-256
    blocks each: ``(cap, idx)`` for every power-of-two class present, in
    ascending ``cap`` — the indices of the frames with ``nblocks`` in
    (cap/2, cap], hashed by one launch of ``max_blocks=cap``.  Frames past
    DEVICE_MAX_BLOCKS are in no class: they spill to hashlib."""
    nblocks = np.asarray(nblocks)
    out = []
    cap = 1
    while cap <= DEVICE_MAX_BLOCKS:
        idx = np.flatnonzero((nblocks <= cap) & (nblocks > cap // 2))
        if len(idx):
            out.append((cap, idx))
        cap *= 2
    return out


def combine(digests) -> bytes:
    """The ordered digest combine — the only sequential stage."""
    comb = hashlib.sha256()
    for d in digests:
        comb.update(d)
    return comb.digest()


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class BucketHashBackend:
    """One way to produce per-frame SHA-256 digests in batch."""

    name = "?"

    def digests(self, frames: List[bytes]) -> List[bytes]:
        raise NotImplementedError

    def hash_frames(self, buf) -> Tuple[bytes, int]:
        """(v2 hash, record count) of a whole framed buffer."""
        frames = split_frames(buf)
        return combine(self.digests(frames)), len(frames)

    def hash_file(self, path: str) -> Tuple[bytes, int]:
        with open(path, "rb") as f:
            return self.hash_frames(f.read())


class HashlibBackend(BucketHashBackend):
    name = "hashlib"

    def digests(self, frames):
        return [hashlib.sha256(f).digest() for f in frames]


class NativeBackend(BucketHashBackend):
    """native/sighash.c: GIL-released, pthread-pool-fanned batches."""

    name = "native"

    def __init__(self, mod):
        self._mod = mod

    def digests(self, frames):
        out = bytearray(32 * len(frames))
        self._mod.sha256_batch(frames, out)
        return [bytes(out[32 * i : 32 * i + 32]) for i in range(len(frames))]

    def hash_frames(self, buf):
        # one C call: frame walk + parallel digests + ordered combine
        return self._mod.bucket_hash_frames(bytes(buf))

    def hash_file(self, path):
        from .. import native

        res = native.bucket_hash_v2_file(path)
        if res is not None:
            return res
        # C reported failure (unreadable or malformed): re-walk in
        # Python for the precise verdict (raises ValueError on corrupt)
        return super().hash_file(path)


class DeviceBackend(BucketHashBackend):
    """The batched multi-block SHA-256 kernel (``ops/sha256_cuda.py``).
    Frames are size-classed into power-of-two ``max_blocks`` shapes
    (``size_classes``: one launch per class present); frames past
    DEVICE_MAX_BLOCKS spill to hashlib (bucket entries are a few hundred
    bytes, so that class is nearly empty).

    ``device="cuda"`` (the default) runs the kernel and builds it here;
    ``device="cpu"`` runs its plain PyTorch version.  ``tracer`` receives
    the stage spans ``bucket.split``, ``bucket.pack``, ``bucket.h2d``,
    ``bucket.kernel`` (launch through the digests' copy back, which waits
    for the kernel) and ``bucket.combine``."""

    def __init__(self, device="cuda", tracer=None):
        self.device = resolve_device(device)
        self.name = f"device-{self.device.type}"
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.device.type == "cuda":
            sha256_cuda.load_library()  # build now, never inside a hash

    def hash_frames(self, buf):
        with self.tracer.span("bucket.split"):
            frames = split_frames(buf)
        digests = self.digests(frames)
        with self.tracer.span("bucket.combine"):
            return combine(digests), len(frames)

    def digests(self, frames):
        out: List[Optional[bytes]] = [None] * len(frames)
        lengths = np.fromiter(map(len, frames), dtype=np.int64, count=len(frames))
        nblocks = (lengths + 8) // 64 + 1
        for i in np.flatnonzero(nblocks > DEVICE_MAX_BLOCKS):
            out[i] = hashlib.sha256(frames[i]).digest()
        for cap, idx in size_classes(nblocks):
            with self.tracer.span("bucket.pack", frames=len(idx), max_blocks=cap):
                packed, counts = sha256.pack_frames([frames[i] for i in idx], max_blocks=cap)
            with self.tracer.span("bucket.h2d", bytes=packed.nbytes):
                p = torch.from_numpy(packed).to(self.device)
                nb = torch.from_numpy(counts).to(self.device)
            with self.tracer.span("bucket.kernel", frames=len(idx)):
                rows = sha256_cuda.digest_rows(p, nb).cpu()
            blob = rows.t().contiguous().numpy().tobytes()
            for j, i in enumerate(idx):
                out[i] = blob[32 * j : 32 * j + 32]
        return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# resolution + throughput stats
# ---------------------------------------------------------------------------


class _Stats:
    """Whole-process hash-plane throughput ledger: bytes hashed and wall
    seconds, and the backend that hashed last."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes = 0
        self._seconds = 0.0
        self._backend_name = ""

    def note(self, nbytes: int, seconds: float, backend: str) -> None:
        with self._lock:
            self._bytes += nbytes
            self._seconds += seconds
            self._backend_name = backend

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bytes": self._bytes,
                "seconds": self._seconds,
                "backend": self._backend_name,
            }

    @staticmethod
    def rate_mb_per_sec(before: dict, after: dict) -> float:
        db = after["bytes"] - before["bytes"]
        dt = after["seconds"] - before["seconds"]
        return round(db / dt / 1e6, 1) if dt > 0 else 0.0


stats = _Stats()

_cache_lock = threading.Lock()
_cache: dict = {}  # guarded by _cache_lock


def backend_by_name(name: str, device="cuda") -> Optional[BucketHashBackend]:
    """An explicit backend instance; None when the native extension does
    not build here.  ``"device"`` runs on ``device`` and raises without
    CUDA unless that is "cpu"."""
    if name == "hashlib":
        return HashlibBackend()
    if name == "native":
        from .. import native

        try:
            return NativeBackend(native.load_sighash())
        except RuntimeError:  # no C toolchain: hashlib gives the same hash
            return None
    if name == "device":
        return DeviceBackend(device=device)
    raise ValueError(f"unknown bucket hash backend {name!r}")


def get_backend(config=None) -> BucketHashBackend:
    """Resolve the active backend: device when ``DEVICE_BUCKET_HASH`` is
    set on ``config`` (on its ``SIG_DEVICE``, raising without CUDA), else
    native when the extension builds, else hashlib."""
    want_device = bool(config is not None and getattr(config, "DEVICE_BUCKET_HASH", False))
    device = str(getattr(config, "SIG_DEVICE", "cuda")) if want_device else None
    no_native = bool(os.environ.get("STELLAR_TPU_NO_NATIVE_HASH"))
    key = (device, no_native)
    with _cache_lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit
    backend: Optional[BucketHashBackend] = None
    if want_device:
        backend = backend_by_name("device", device=device)
    elif not no_native:
        backend = backend_by_name("native")
    if backend is None:
        backend = HashlibBackend()
    with _cache_lock:
        _cache[key] = backend
    return backend


def reset_backend_cache() -> None:
    """Drop resolved backends (knob/env changes re-resolve)."""
    with _cache_lock:
        _cache.clear()


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def hash_frames(buf, config=None) -> Tuple[bytes, int]:
    """(v2 bucket hash, record count) of a framed record buffer.
    Raises ValueError on a malformed/truncated frame."""
    backend = get_backend(config)
    t0 = time.perf_counter()
    out = backend.hash_frames(buf)
    stats.note(len(buf), time.perf_counter() - t0, backend.name)
    return out


def hash_file(path: str, config=None) -> Tuple[bytes, int]:
    """(v2 bucket hash, record count) of a bucket file on disk.  Raises
    OSError when unreadable, ValueError when malformed."""
    backend = get_backend(config)
    t0 = time.perf_counter()
    out = backend.hash_file(path)
    stats.note(os.path.getsize(path), time.perf_counter() - t0, backend.name)
    return out


class BucketHasher:
    """The bucket writers' streaming hasher: ``add`` takes EXACTLY ONE full
    frame per call and ``finish`` returns the v2 hash.  Frames batch up to
    ~4 MB before a backend digest pass, so memory stays bounded on
    million-record merges while batches stay big enough to fan out."""

    def __init__(self, config=None):
        self._backend = get_backend(config)
        self._comb = hashlib.sha256()
        self._pending: List[bytes] = []
        self._pending_bytes = 0
        self._count = 0
        self._finished = False

    def add(self, frame) -> None:
        if self._finished:
            raise RuntimeError("hash already finished")
        self._pending.append(bytes(frame))
        self._pending_bytes += len(frame)
        self._count += 1
        if self._pending_bytes >= _FLUSH_BYTES:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        t0 = time.perf_counter()
        for d in self._backend.digests(self._pending):
            self._comb.update(d)
        stats.note(self._pending_bytes, time.perf_counter() - t0, self._backend.name)
        self._pending = []
        self._pending_bytes = 0

    @property
    def count(self) -> int:
        return self._count

    def finish(self) -> bytes:
        self._flush()
        self._finished = True
        return self._comb.digest()
