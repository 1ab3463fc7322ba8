"""The device-hash verify path of the port: the C host stage's stage_raw, the
plain SHA-512-mod-L stage (stellar_tpu_torch/ops/sha512.py), its Hopper
kernel (csrc/sha512_h.cu, wrapper ops/sha512_cuda.py) and
BatchVerifier(device_hash=True), against the JAX package on this CPU host.

CUDA has no interpret mode, so the kernel source is also compiled as host
C++ with a block emulation (tests/torch_host_cuda.py: each CUDA thread an
OS thread, so the schedule warp and the round warp of a block run beside
each other and meet at the stage barriers) and held against the plain
version and the JAX stage, on both load paths, ragged lane counts, flag-0
blocks, in place as well as into a separate output; the run on the card
is the ``cuda`` test, which skips without CUDA.  JAX is imported
in a fixture (the card's machine has none, and its ``cuda`` tests run
without it); its side is kept to one compiled stage shape (160, 64) and one
verifier bucket (64).  Tolerance: exact — bytes equal byte for byte,
verdicts equal.
"""

import ctypes
import hashlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stellar_tpu_torch import native as tnative  # noqa: E402
from stellar_tpu_torch.crypto import SecretKey, make_backend, sodium  # noqa: E402
from stellar_tpu_torch.crypto.sigcache import VerifySigCache  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from stellar_tpu_torch.ops import ed25519_cuda  # noqa: E402
from stellar_tpu_torch.ops import sha512 as tsha  # noqa: E402
from stellar_tpu_torch.ops import sha512_cuda  # noqa: E402
from torch_host_cuda import build_host_kernel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

L = tsha.L
LANES = 64  # the one JAX stage shape of this file


def _valid_items(n, seed=91000, mlens=(0, 1, 31, 32, 46, 47, 48, 64, 200)):
    """Signed triples whose message lengths sweep the single/multi-block
    boundary (preimage 64 + mlen: 95/96 and 111/112 bytes bracketed)."""
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(seed + i)
        mlen = mlens[i % len(mlens)]
        msg = bytes((seed + i + j) % 256 for j in range(mlen))
        items.append((sk.public_raw, msg, sk.sign(msg)))
    return items


def _hostile_items(seed=92000):
    sk = SecretKey.pseudo_random_for_testing(seed)
    msg = b"hostile lane"
    pk, sig = sk.public_raw, sk.sign(msg)
    bad_r = bytearray(sig)
    bad_r[3] ^= 0x10
    return [
        (pk, msg, sig[:32] + L.to_bytes(32, "little")),  # s = L
        (pk, msg, sig[:32] + (L + 7).to_bytes(32, "little")),  # s > L
        (pk, msg, sig[:32] + (2**256 - 1).to_bytes(32, "little")),
        (pk, b"different message", sig),  # wrong msg
        (pk, msg, bytes(bad_r)),  # corrupt R
        (bytes(32), msg, sig),  # small-order A
        (pk[:31], msg, sig),  # short pk
        (pk, msg, sig[:63]),  # short sig
        (pk, msg, sig),  # valid control
    ]


def _staged(items, stride=LANES):
    """The port's stage_raw over ``items`` into a (160, stride) buffer."""
    out = np.full((tsha.DH_ROWS, stride), 0xAB, dtype=np.uint8)
    ok = np.zeros(stride, dtype=np.uint8)
    rej = tnative.load_sighash().stage_raw(items, 0, len(items), out, ok, ted._BLACKLIST, 0)
    return out, ok[: len(items)], rej


def _random_lanes(seed):
    """(160, LANES) flag-1 lanes of random R, A and every mlen 0..47."""
    rng = np.random.default_rng(seed)
    p = np.zeros((tsha.DH_ROWS, LANES), dtype=np.uint8)
    want = []
    for j in range(LANES):
        r, a, m = rng.bytes(32), rng.bytes(32), rng.bytes(j % 48)
        p[0:32, j] = np.frombuffer(a, np.uint8)
        p[32:64, j] = np.frombuffer(r, np.uint8)
        if m:
            p[tsha.ROW_M : tsha.ROW_M + len(m), j] = np.frombuffer(m, np.uint8)
        p[tsha.ROW_MLEN, j] = len(m)
        p[tsha.ROW_FLAG, j] = 1
        want.append(np.frombuffer(tsha.reduce_digest(hashlib.sha512(r + a + m).digest()), np.uint8))
    return p, np.stack(want, axis=1)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, and its h stage jitted once."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from stellar_tpu import native
    from stellar_tpu.ops import ed25519, sha512

    return types.SimpleNamespace(
        jnp=jnp, native=native, ed25519=ed25519, h=jax.jit(sha512.h_rows_from_packed)
    )


def _jax_h(jx, p):
    return np.asarray(jx.h(jx.jnp.asarray(p)))


def test_stage_raw_byte_exact_with_jax(jx):
    """stage_raw fills the (160, ·) buffer, the ok vector and the reject
    count exactly as the JAX package's build does: raw single-block lanes
    with flag 1, host-hashed multi-block lanes with flag 0, inert rejected
    lanes, zeroed padding columns."""
    items = _valid_items(24) + _hostile_items()
    n = len(items)
    outs = []
    for mod in (tnative.load_sighash(), jx.native.load_sighash()):
        packed = np.full((tsha.DH_ROWS, LANES), 0xAB, dtype=np.uint8)
        ok = np.full(LANES, 7, dtype=np.uint8)
        rej = mod.stage_raw(items, 0, n, packed, ok, ted._BLACKLIST, 0)
        outs.append((packed, ok[:n].copy(), rej))
    (tp, tok, trej), (jp, jok, jrej) = outs
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tok, jok)
    assert trej == jrej > 0
    flags = tp[tsha.ROW_FLAG, :n]
    mlens = np.array([len(it[1]) for it in items])
    assert set(flags[(tok == 1) & (mlens <= 47)]) == {1}
    assert set(flags[(tok == 1) & (mlens > 47)]) == {0}
    assert not tp[:, n:].any()  # padding columns are inert


def test_h_rows_match_jax_and_hashlib(jx):
    p, want = _random_lanes(seed=7)
    got = tsha.h_rows_from_packed(torch.from_numpy(p))
    assert got.dtype == torch.int32 and got.shape == (32, LANES)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), _jax_h(jx, p))


def test_staged_chunk_h_rows_match_jax(jx):
    """On a stage_raw chunk, flag-1 lanes hash on the (plain) device stage
    and flag-0 lanes keep the host h: both equal h = SHA-512(R‖A‖M) mod L
    on every gate-passing lane."""
    items = _valid_items(36) + _hostile_items()
    p, ok, _ = _staged(items)
    got = tsha.h_rows_from_packed(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, _jax_h(jx, p))
    for j, (pk, msg, sig) in enumerate(items):
        if ok[j]:
            want = tsha.reduce_digest(hashlib.sha512(sig[:32] + pk + msg).digest())
            assert bytes(got[:, j].astype(np.uint8)) == want, j


def test_all_flag0_chunk_passes_through(jx):
    rng = np.random.default_rng(8)
    p = rng.integers(0, 256, (tsha.DH_ROWS, LANES), dtype=np.uint8)
    p[tsha.ROW_FLAG] = 0
    calls = tsha.plain_calls
    got = tsha.h_rows_from_packed(torch.from_numpy(p)).numpy()
    assert tsha.plain_calls == calls + 1
    np.testing.assert_array_equal(got, p[96:128].astype(np.int32))
    np.testing.assert_array_equal(got, _jax_h(jx, p))
    # hash_in_place on the CPU leaves such a chunk as it was
    t = torch.from_numpy(p.copy())
    sha512_cuda.hash_in_place(t)
    np.testing.assert_array_equal(t.numpy(), p)


_MOD_L_EDGES = [
    0, 1, L - 1, L, L + 1, 1 << 252, (1 << 252) - 1, 8 * L, (1 << 512) - 1,
    ((1 << 512) // L) * L, ((1 << 385) // L) * L, ((1 << 260) // L) * L - 1,
]


def test_mod_l_edges_vs_bigints():
    rng = np.random.default_rng(9)
    vals = _MOD_L_EDGES + [int.from_bytes(rng.bytes(64), "little") for _ in range(24)]
    d = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals], axis=1)
    rows = tsha._mod_l_rows(list(torch.from_numpy(d.astype(np.int64)).unbind(0)))
    got = torch.stack(rows).numpy().astype(np.uint8)
    for j, v in enumerate(vals):
        assert bytes(got[:, j]) == (v % L).to_bytes(32, "little"), j


# -- the CUDA source, compiled as host C++ ----------------------------------

_HOST_LOOP = r"""
extern "C" void host_h(const uint8_t *p, uint8_t *out, int n, int words) {
    host_launch((n + kLanes - 1) / kLanes, kThreads, 32,
                [&] { sha512_h_kernel(p, out, n, words != 0); });
}
extern "C" void host_mod_l(const uint32_t *x, uint32_t *r) {
    uint32_t xx[16], rr[8];
    for (int k = 0; k < 16; k++) xx[k] = x[k];
    mod_l(xx, rr);
    for (int k = 0; k < 8; k++) r[k] = rr[k];
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    lib = build_host_kernel(
        sha512_cuda.SOURCE, _HOST_LOOP, tmp_path_factory.mktemp("sha512_host"), threads=True
    )
    lib.host_h.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.host_h.restype = None
    lib.host_mod_l.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.host_mod_l.restype = None
    return lib


def _host_h(lib, p, in_place=False, words=None):
    """The kernel over the (160, n) chunk ``p`` as its launch runs it (two
    warps a block of 32 lanes; 32-bit loads where n % 4 == 0 unless
    ``words`` says otherwise): the new (32, n) h rows, or ``p`` after the
    in-place call."""
    n = p.shape[1]
    words = n % 4 == 0 if words is None else words
    if in_place:
        q = np.ascontiguousarray(p).copy()
        lib.host_h(q.ctypes.data, q.ctypes.data + 96 * n, n, int(words))
        return q
    p = np.ascontiguousarray(p)
    out = np.full((32, n), 0xA5, dtype=np.uint8)
    lib.host_h(p.ctypes.data, out.ctypes.data, n, int(words))
    return out


def _plain(p):
    return tsha.h_rows_from_packed(torch.from_numpy(np.ascontiguousarray(p))).numpy().astype(np.uint8)


def _mixed_chunk():
    """stage_raw lanes (flag 1 and 0, inert rejects) beside random flag-1
    lanes at every mlen, out-of-range mlen/flag bytes on a few."""
    staged, _, _ = _staged(_valid_items(36) + _hostile_items())
    rand, _ = _random_lanes(seed=11)
    p = np.concatenate([staged, rand], axis=1)
    p[tsha.ROW_MLEN, -3:] = [48, 200, 255]  # the plain version's formula
    p[tsha.ROW_FLAG, -5:-3] = [2, 255]  # any nonzero flag hashes
    return np.ascontiguousarray(p)


def test_kernel_source_matches_plain_version(host_kernel):
    p = _mixed_chunk()
    plain = _plain(p)
    np.testing.assert_array_equal(_host_h(host_kernel, p), plain)
    # in place: h lands in rows 96:128 of the chunk itself, nothing else moves
    q = _host_h(host_kernel, p, in_place=True)
    np.testing.assert_array_equal(q[96:128], plain)
    np.testing.assert_array_equal(q[:96], p[:96])
    np.testing.assert_array_equal(q[128:], p[128:])


def test_kernel_source_matches_jax_on_a_staged_chunk(jx, host_kernel):
    """A stage_raw chunk of the JAX stage shape (160, 64): the boundary
    lengths of tests/test_sha512_device.py, multi-block lanes with the host
    h, gate-rejected lanes."""
    p, ok, rej = _staged(_valid_items(40, mlens=(0, 1, 2, 31, 32, 33, 46, 47, 48, 64)) + _hostile_items())
    assert rej > 0 and 0 < ok.sum() < len(ok)
    got = _host_h(host_kernel, p)
    np.testing.assert_array_equal(got, _jax_h(jx, p).astype(np.uint8))
    np.testing.assert_array_equal(got, _plain(p))


def test_kernel_source_every_mlen_both_load_paths(host_kernel):
    """Every mlen 0..47 (and 48, 200, 255 with flag 1): the 32-bit word
    loads and the byte loads give the same h, the plain version's."""
    p = _mixed_chunk()
    plain = _plain(p)
    assert set(range(48)) <= set(p[tsha.ROW_MLEN][p[tsha.ROW_FLAG] != 0].tolist())
    np.testing.assert_array_equal(_host_h(host_kernel, p, words=True), plain)
    np.testing.assert_array_equal(_host_h(host_kernel, p, words=False), plain)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 36, 70])
def test_kernel_source_on_ragged_lane_counts(host_kernel, n):
    """A last block with fewer than 32 live lanes, on both load paths
    (n % 4 == 0 takes the word loads), into a new tensor and in place."""
    p = np.ascontiguousarray(np.concatenate([_mixed_chunk()] * 2, axis=1)[:, 29 : 29 + n])
    plain = _plain(p)
    np.testing.assert_array_equal(_host_h(host_kernel, p), plain)
    q = _host_h(host_kernel, p, in_place=True)
    np.testing.assert_array_equal(q[96:128], plain)
    np.testing.assert_array_equal(np.delete(q, np.s_[96:128], axis=0), np.delete(p, np.s_[96:128], axis=0))


def test_kernel_source_flag0_blocks_pass_through(host_kernel):
    """A block whose lanes all have flag 0 skips the rounds and writes the
    host h through; a whole chunk of them in place comes back unchanged."""
    p = _mixed_chunk()
    p[tsha.ROW_FLAG, :32] = 0  # block 0: no lane to hash
    plain = _plain(p)
    np.testing.assert_array_equal(plain[:, :32], p[96:128, :32])
    np.testing.assert_array_equal(_host_h(host_kernel, p), plain)
    p[tsha.ROW_FLAG] = 0
    np.testing.assert_array_equal(_host_h(host_kernel, p, in_place=True), p)
    np.testing.assert_array_equal(_host_h(host_kernel, p), p[96:128])


def test_kernel_source_mod_l_edges(host_kernel):
    rng = np.random.default_rng(10)
    vals = _MOD_L_EDGES + [int.from_bytes(rng.bytes(64), "little") for _ in range(200)]
    for v in vals:
        x = np.frombuffer(v.to_bytes(64, "little"), dtype="<u4").copy()
        r = np.zeros(8, dtype="<u4")
        host_kernel.host_mod_l(x.ctypes.data, r.ctypes.data)
        assert r.tobytes() == (v % L).to_bytes(32, "little"), hex(v)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    p = torch.from_numpy(_random_lanes(seed=12)[0])
    launches, calls = sha512_cuda.launches, tsha.plain_calls
    got = sha512_cuda.h_rows(p)
    assert got.dtype == torch.uint8 and got.shape == (32, LANES)
    np.testing.assert_array_equal(got.numpy(), tsha.h_rows_from_packed(p).numpy())
    q = p.clone()
    sha512_cuda.hash_in_place(q)
    assert torch.equal(q[96:128], got) and torch.equal(q[:96], p[:96])
    assert sha512_cuda.launches == launches and tsha.plain_calls == calls + 3
    with pytest.raises(ValueError):
        sha512_cuda.h_rows(p.to("meta"))


# -- BatchVerifier(device_hash=True) -----------------------------------------


def test_batch_verifier_device_hash_matches_jax_and_host_hash(jx):
    items = _valid_items(45) + _hostile_items()
    want = [sodium.verify_detached(s, m, p) for p, m, s in items]
    dev = ted.BatchVerifier(device="cpu", max_batch=32, device_hash=True)
    host = ted.BatchVerifier(device="cpu", max_batch=32)
    calls = tsha.plain_calls
    assert dev.verify(items) == want
    assert tsha.plain_calls == calls + 2  # two chunks, both with flag-1 lanes
    assert host.verify(items) == want
    jbv = jx.ed25519.BatchVerifier(
        max_batch=64, min_device_batch=64, backend="xla", device_hash=True
    )
    assert jbv.verify(items) == want
    assert any(want) and not all(want)
    assert dev.stats()["device_hash"] is True and host.stats()["device_hash"] is False
    # a chunk of multi-block messages only: no lane for the hash stage
    long_items = [it for it in items if len(it[1]) > 47]
    assert dev.verify(long_items) == [sodium.verify_detached(s, m, p) for p, m, s in long_items]
    # torsion proofs stay on the 128-row layout, no hash stage
    encs = [it[0] for it in items[:4]] + [bytes(32)]
    assert dev.verify_torsion(encs) == host.verify_torsion(encs) == [True] * 4 + [False]


def test_make_backend_plumbs_device_hash(monkeypatch):
    backend = make_backend("gpu", cache=VerifySigCache(), device="cpu", device_hash=True)
    backend.inner.DEVICE_FIRST_TIMEOUT = 600.0  # the plain version's first run
    items = _valid_items(9, seed=93000)
    launches = (ed25519_cuda.launches, sha512_cuda.launches)
    assert backend.verify_batch(items) == [True] * 9
    st = backend.stats()
    assert st["device_hash"] is True and st["device_calls"] == 1
    # the tensors lay on the CPU: the plain versions ran, no kernel
    assert (ed25519_cuda.launches, sha512_cuda.launches) == launches
    monkeypatch.setenv("STELLAR_TPU_DEVICE_HASH", "1")
    assert make_backend("gpu", cache=VerifySigCache(), device="cpu").stats()["device_hash"] is True
    monkeypatch.setenv("STELLAR_TPU_DEVICE_HASH", "0")
    assert make_backend("gpu", cache=VerifySigCache(), device="cpu").stats()["device_hash"] is False


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    mixed = _mixed_chunk()
    # 128 lanes, a ragged 33 (byte loads) and 904 (a ledger's tail chunk)
    for n in (mixed.shape[1], 33, 904):
        p = torch.from_numpy(np.ascontiguousarray(np.tile(mixed, (1, 8))[:, :n])).cuda()
        launches = sha512_cuda.launches
        got = sha512_cuda.h_rows(p)
        q = p.clone()
        sha512_cuda.hash_in_place(q)
        torch.cuda.synchronize()
        assert sha512_cuda.launches == launches + 2
        plain = tsha.h_rows_from_packed(p).to(torch.uint8)
        assert torch.equal(got, plain) and torch.equal(q[96:128], plain), n
        assert torch.equal(q[:96], p[:96]) and torch.equal(q[128:], p[128:]), n
    flag0 = p.clone()
    flag0[tsha.ROW_FLAG] = 0
    before = flag0.clone()
    sha512_cuda.hash_in_place(flag0)
    assert torch.equal(flag0, before)
    with pytest.raises(ValueError):
        sha512_cuda.h_rows(p[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        sha512_cuda.h_rows(p[:128].contiguous())  # not 160 rows


@pytest.mark.cuda
def test_noop_launch_on_card():
    """The empty kernel that times a launch's floor runs and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    launches = sha512_cuda.launches
    sha512_cuda.launch_noop(torch.device("cuda"))
    torch.cuda.synchronize()
    assert sha512_cuda.launches == launches


@pytest.mark.cuda
def test_batch_verifier_device_hash_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    items = _valid_items(45) + _hostile_items()
    want = [True] * 45 + [False] * 8 + [True]  # by construction: no libsodium there
    bv = ted.BatchVerifier(max_batch=32, device_hash=True)
    launches, calls = sha512_cuda.launches, tsha.plain_calls
    assert bv.verify(items) == want
    assert sha512_cuda.launches == launches + 2 and tsha.plain_calls == calls
