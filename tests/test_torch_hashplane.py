"""The port's bucket-hash plane (stellar_tpu_torch/bucket/hashplane.py)
against the JAX package's (stellar_tpu/bucket/hashplane.py) and hashlib, on
this CPU host.

The port's three backends — hashlib, native (its own sighash.c build) and
device (here ``device="cpu"``: the SHA-256 kernel's plain PyTorch version)
— must give the JAX package's v2 hash and record count on the same framed
buffers, including the empty bucket and frames past DEVICE_MAX_BLOCKS that
spill to hashlib.  The JAX side runs its hashlib and native backends (its
device backend is held to those by its own tests).  Tolerance: exact —
hashes equal byte for byte, counts equal.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stellar_tpu.bucket import hashplane as jhp  # noqa: E402
from stellar_tpu_torch.bucket import hashplane as hp  # noqa: E402
from stellar_tpu_torch.ops import sha256 as tsha  # noqa: E402
from stellar_tpu_torch.ops import sha256_cuda  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)


def frame(body: bytes) -> bytes:
    return struct.pack(">I", 0x80000000 | len(body)) + body


def framed(*bodies) -> bytes:
    return b"".join(frame(b) for b in bodies)


@pytest.fixture(autouse=True)
def _clean_cache():
    hp.reset_backend_cache()
    jhp.reset_backend_cache()
    yield
    hp.reset_backend_cache()
    jhp.reset_backend_cache()


BODIES = [
    b"",  # minimal frame: header only
    b"x",
    bytes(range(51)),  # frame = 55 B (single-block padding edge)
    bytes(range(52)),  # frame = 56 B (spills into block 2)
    bytes(range(60)),  # frame = 64 B
    bytes(range(61)),  # frame = 65 B
    bytes(range(115)),  # frame = 119 B
    bytes(range(116)),  # frame = 120 B
    bytes(range(200)) + bytes(200),  # multi-block
    b"\xff" * 997,
]
# one frame past DEVICE_MAX_BLOCKS compression blocks: the device backend
# digests it with hashlib and merges it in order
BIG = bytes(range(256)) * ((hp.DEVICE_MAX_BLOCKS * 64) // 256 + 2)


def expected_v2(bodies):
    return jhp.combine(hashlib.sha256(frame(b)).digest() for b in bodies)


def _port_backends():
    return [hp.HashlibBackend(), hp.backend_by_name("native"), hp.DeviceBackend(device="cpu")]


def _jax_backends():
    return [jhp.HashlibBackend(), jhp.backend_by_name("native")]


class TestFrameWalk:
    def test_split_matches_jax(self):
        buf = framed(*BODIES)
        assert hp.split_frames(buf) == jhp.split_frames(buf) == [frame(b) for b in BODIES]
        assert hp.split_frames(b"") == []

    @pytest.mark.parametrize(
        "buf",
        [
            b"\x80",  # truncated header
            b"\x80\x00\x00",  # still truncated
            struct.pack(">I", 5),  # continuation bit missing
            struct.pack(">I", 0x80000000 | 10) + b"short",  # truncated body
            struct.pack(">I", 0x80000000 | ((64 << 20) + 1)),  # oversized
            framed(b"good") + b"\x80\x00",  # good frame then garbage
        ],
    )
    def test_hostile_buffers_raise_on_every_backend(self, buf):
        with pytest.raises(ValueError):
            hp.split_frames(buf)
        for be in _port_backends():
            with pytest.raises(ValueError):
                be.hash_frames(buf)


class TestBackendsAgainstJax:
    @pytest.mark.parametrize(
        "bodies",
        [BODIES, [], [b"small", BIG, b"also-small"], [bytes([i % 7]) * (90 + i % 110) for i in range(300)]],
        ids=["boundaries", "empty_bucket", "oversized_spill", "entry_sizes"],
    )
    def test_same_hash_and_count(self, bodies):
        buf = framed(*bodies)
        want = (expected_v2(bodies), len(bodies))
        for be in _jax_backends():
            assert be.hash_frames(buf) == want, be.name
        assert jhp.hash_frames(buf) == want
        calls = tsha.plain_calls
        for be in _port_backends():
            assert be.hash_frames(buf) == want, be.name
            assert be.digests(hp.split_frames(buf)) == jhp.HashlibBackend().digests(
                jhp.split_frames(buf)
            ), be.name
        assert hp.hash_frames(buf) == want
        # the device backend ran its kernel's plain version, one run per
        # size class present in each of its two passes
        assert (tsha.plain_calls > calls) == any(
            tsha.blocks_for(len(frame(b))) <= hp.DEVICE_MAX_BLOCKS for b in bodies
        )

    def test_device_backend_size_classes_and_spill(self):
        # frames of 1, 2, 3 and 5 blocks: the power-of-two classes 1, 2, 4, 8
        bodies = [b"a", bytes(60), bytes(130), bytes(260), BIG]
        tracer = _SpanNames()
        dev = hp.DeviceBackend(device="cpu", tracer=tracer)
        calls, launches = tsha.plain_calls, sha256_cuda.launches
        assert dev.hash_frames(framed(*bodies)) == (expected_v2(bodies), 5)
        assert tsha.plain_calls == calls + 4 and sha256_cuda.launches == launches
        assert tracer.names.count("bucket.kernel") == 4
        assert {"bucket.split", "bucket.pack", "bucket.h2d", "bucket.combine"} <= set(tracer.names)
        assert dev.name == "device-cpu"

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_size_classes_reproduce_the_jax_cut_and_digests(self, seed):
        # the JAX device backend's cut: each frame's class is the least
        # power of two >= its block count; past DEVICE_MAX_BLOCKS, hashlib
        rng = np.random.default_rng(seed)
        nblocks = rng.integers(1, 2 * hp.DEVICE_MAX_BLOCKS, 400)
        want = {}
        for i, nb in enumerate(nblocks):
            if nb <= hp.DEVICE_MAX_BLOCKS:
                want.setdefault(1 << (int(nb) - 1).bit_length(), []).append(i)
        got = hp.size_classes(nblocks)
        assert [cap for cap, _ in got] == sorted(want)
        assert all(idx.tolist() == want[cap] for cap, idx in got)
        assert hp.size_classes(np.zeros(0, dtype=np.int64)) == []
        # the device backend hashes by that cut, one plain run a class
        bodies = [bytes([i % 251]) * int(64 * (nb % 9) + 52) for i, nb in enumerate(nblocks[:40])]
        frames = [frame(b) for b in bodies]
        dev = hp.DeviceBackend(device="cpu")
        calls = tsha.plain_calls
        assert dev.digests(frames) == [hashlib.sha256(f).digest() for f in frames]
        lengths = np.array([len(f) for f in frames])
        assert tsha.plain_calls == calls + len(hp.size_classes((lengths + 8) // 64 + 1))


class _SpanNames:
    def __init__(self):
        self.names = []

    def span(self, name, **attrs):
        import contextlib

        self.names.append(name)
        return contextlib.nullcontext()


class TestStreamingHasher:
    def test_streaming_matches_batch_and_jax(self):
        buf = framed(*BODIES)
        for config in (None, _Knob(False)):
            h = hp.BucketHasher(config)
            for f in hp.split_frames(buf):
                h.add(f)
            assert (h.finish(), h.count) == hp.hash_frames(buf) == jhp.hash_frames(buf)
        with pytest.raises(RuntimeError):
            h.add(frame(b"late"))

    def test_flush_boundary_equivalence(self, monkeypatch):
        """Across the 4 MB flush boundary (shrunk to 300 bytes here, so the
        frames batch in several flushes) every backend streams to the batch
        hash."""
        bodies = [bytes([i]) * (40 + 7 * i) for i in range(40)]
        buf = framed(*bodies)
        want = (expected_v2(bodies), len(bodies))
        monkeypatch.setattr(hp, "_FLUSH_BYTES", 300)
        for be in _port_backends():
            monkeypatch.setattr(hp, "get_backend", lambda config=None, be=be: be)
            h = hp.BucketHasher()
            for f in hp.split_frames(buf):
                h.add(f)
            assert (h.finish(), h.count) == want, be.name

    def test_empty_stream(self):
        h = hp.BucketHasher()
        assert h.finish() == hashlib.sha256(b"").digest() and h.count == 0


class _Knob:
    def __init__(self, on):
        self.DEVICE_BUCKET_HASH = on


class TestResolutionAndFiles:
    def test_hash_file_matches_hash_frames(self, tmp_path):
        buf = framed(*BODIES)
        path = tmp_path / "bucket.xdr"
        path.write_bytes(buf)
        want = hp.hash_frames(buf)
        assert hp.hash_file(str(path)) == want == jhp.hash_file(str(path))
        for be in _port_backends():
            assert be.hash_file(str(path)) == want, be.name
        path.write_bytes(buf + b"\x80")
        with pytest.raises(ValueError):
            hp.hash_file(str(path))

    def test_default_resolution_and_no_native_env(self, monkeypatch):
        assert hp.get_backend().name == "native"
        assert hp.get_backend(_Knob(False)).name == "native"
        monkeypatch.setenv("STELLAR_TPU_NO_NATIVE_HASH", "1")
        hp.reset_backend_cache()
        assert hp.get_backend().name == "hashlib"

    def test_knob_on_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA: the knob resolves the device backend")
        with pytest.raises(RuntimeError, match="CUDA"):
            hp.get_backend(_Knob(True))
        with pytest.raises(RuntimeError, match="CUDA"):
            hp.hash_frames(framed(b"x"), _Knob(True))
        with pytest.raises(RuntimeError, match="CUDA"):
            hp.BucketHasher(_Knob(True))

    def test_stats_note_bytes_and_backend(self):
        before = hp.stats.snapshot()
        buf = framed(*BODIES)
        hp.hash_frames(buf)
        after = hp.stats.snapshot()
        assert after["bytes"] - before["bytes"] == len(buf)
        assert after["backend"] == "native"
        with pytest.raises(ValueError):
            hp.backend_by_name("device-xla")
