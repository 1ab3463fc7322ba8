"""The hand-written Hopper verify kernel (stellar_tpu_torch/csrc/
ed25519_verify.cu) and its wrapper (ops/ed25519_cuda.py).

CUDA has no interpret mode, so on a host without a card the kernel's
arithmetic is still held against its plain PyTorch version by compiling the
same source as host C++ with a block emulation (tests/torch_host_cuda.py:
each CUDA thread an OS thread, the group's warp shuffles an exchange behind
a barrier) and running it on the lane mix chip_smoke.py uses on the card,
on R edge lanes and on ragged lane counts.  The run on the card itself is
the ``cuda`` tests below, which skip without CUDA.  Tolerance: exact
(boolean verdicts).
"""

import ctypes
import hashlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from stellar_tpu_torch.crypto import SecretKey  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ed  # noqa: E402
from stellar_tpu_torch.ops import ed25519_cuda as ec  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as ref  # noqa: E402
from torch_host_cuda import build_host_kernel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

# the kernel's launch geometry: 4 threads a lane, 64-thread blocks
_GROUP, _BLOCK = 4, 64

_HOST_LOOP = r"""
extern "C" void host_verify(const uint8_t *p, uint8_t *out, int n,
                            const int32_t *consts, int block_threads) {
    const int lanes = block_threads / 4;
    host_launch((n + lanes - 1) / lanes, block_threads, 4,
                [&] { ed25519_verify_kernel(p, out, n, consts); });
}
"""


def _lanes(n, seed):
    rng = random.Random(seed)
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(1000 + i)
        msg = rng.getrandbits(256).to_bytes(32, "little")
        items.append((sk.public_raw, msg, sk.sign(msg)))
    return chip_smoke.kernel_lanes(rng, items, n)


def _enc(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _h(R, A, M) -> bytes:
    return _enc(int.from_bytes(hashlib.sha512(R + A + M).digest(), "little") % ref.L)


def _pack(cols):
    packed = np.zeros((128, len(cols)), dtype=np.uint8)
    for i, col in enumerate(cols):
        for row, b in zip((0, 32, 64, 96), col):
            packed[row : row + 32, i] = np.frombuffer(b, dtype=np.uint8)
    return packed


_SIGN = 1 << 255
_ZERO = bytes(32)


def _edge_lanes(case):
    """Lanes (A, R, s, h) of one R edge class, with the verdicts known by
    construction.  s = 0, h = 0 makes P the identity; s = 0, h = 1 makes
    P = −A."""
    sk = SecretKey.pseudo_random_for_testing(77)
    pk, msg = sk.public_raw, b"R edge lanes"
    sig = sk.sign(msg)
    R, S = sig[:32], sig[32:]
    H = _h(R, pk, msg)
    one = _enc(1)
    if case == "y_is_p":
        # A of order 4, y = 0; P = −A, whose y = 0 also encodes as y = p
        t4 = ref.decompress(_ZERO)
        a = ref.compress(t4)
        r = ref.compress(ref.scalar_mult(3, t4))
        alias = _enc(ref.P | (r[31] >> 7) << 255)
        return [(a, r, _ZERO, one), (a, alias, _ZERO, one)], [True, False]
    if case == "y_is_p_plus_1":  # the identity's alias
        return [(pk, one, _ZERO, _ZERO), (pk, _enc(ref.P + 1), _ZERO, _ZERO)], [True, False]
    if case == "y_ge_p_signed":
        cols = [(pk, _enc((ref.P + k) | _SIGN), _ZERO, _ZERO) for k in (0, 1, 5, 18)]
        cols.append((pk, _enc((ref.P + 1) | _SIGN), S, _h(_enc((ref.P + 1) | _SIGN), pk, msg)))
        return cols + [(pk, R, S, H)], [False] * 5 + [True]
    if case == "x0_sign":  # y = 1 with bit 255 set: x = 0 and the sign set
        return [(pk, _enc(1 | _SIGN), _ZERO, _ZERO), (pk, one, _ZERO, _ZERO)], [False, True]
    if case == "sign_flipped":
        flipped = R[:31] + bytes([R[31] ^ 0x80])
        cols = [(pk, flipped, S, H), (pk, flipped, S, _h(flipped, pk, msg)), (pk, R, S, H)]
        return cols, [False, False, True]
    if case == "torsion":
        # A := P, s := 0, h := L, R := the identity's encoding: [L]·P == I
        t8 = ref.scalar_mult(ref.L, ref.decompress(_enc(3)))
        mixed = ref.compress(ref.point_add(ref.decompress(pk), t8))
        encs = [pk, one, mixed, *ref.small_order_blacklist()[:3]]
        want = [ref.is_torsion_free(ref.decompress(e)) for e in encs]
        return [(e, one, _ZERO, _enc(ref.L)) for e in encs], want
    raise AssertionError(case)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    lib = build_host_kernel(
        ec.SOURCE, _HOST_LOOP, tmp_path_factory.mktemp("kernel_host"), threads=True
    )
    lib.host_verify.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.host_verify.restype = None
    return lib


def _host_verify(lib, packed, block_threads=_BLOCK):
    packed = np.ascontiguousarray(packed)
    consts = ec.kernel_constants()
    out = np.full(packed.shape[1], 7, dtype=np.uint8)  # every lane must be written
    lib.host_verify(packed.ctypes.data, out.ctypes.data, packed.shape[1], consts.ctypes.data, block_threads)
    assert set(out.tolist()) <= {0, 1}, out
    return out.astype(bool)


def test_kernel_source_matches_plain_version(host_kernel):
    packed = _lanes(64, seed=8)
    got = _host_verify(host_kernel, packed)
    plain = ed._verify_packed(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, plain)
    assert plain.any() and not plain.all()
    assert plain[5::8].all()  # s >= L on a valid signature verifies (mod L)


@pytest.mark.parametrize(
    "case", ["y_is_p", "y_is_p_plus_1", "y_ge_p_signed", "x0_sign", "sign_flipped", "torsion"]
)
def test_kernel_source_on_r_edge_lanes(host_kernel, case):
    """R is checked by decoding it beside A, not by encoding P: lanes where
    the two could part (R's y >= p, x = 0 with the sign set, the sign bit)
    keep the plain version's verdict."""
    cols, want = _edge_lanes(case)
    packed = _pack(cols)
    plain = ed._verify_packed(torch.from_numpy(packed)).numpy()
    assert plain.tolist() == want
    np.testing.assert_array_equal(_host_verify(host_kernel, packed), plain)


@pytest.mark.parametrize("n", [1, 3, 33])
def test_kernel_source_on_ragged_lane_counts(host_kernel, n):
    """A lane count that fills no whole block (nor warp): the tail's groups
    clamp their lane, take part in every shuffle and store nothing."""
    packed = _lanes(64, seed=8)[:, :n]
    plain = ed._verify_packed(torch.from_numpy(np.ascontiguousarray(packed))).numpy()
    np.testing.assert_array_equal(_host_verify(host_kernel, packed), plain)


def test_kernel_constants_encode_the_shared_tables():
    c = ec.kernel_constants().astype(np.int64)

    def val(limbs):
        v, off = 0, 0
        for i, l in enumerate(limbs):
            v += int(l) << off
            off += 25 if i & 1 else 26
        return v

    tab = c[: 16 * 4 * 10].reshape(16, 4, 10)
    for k, (ypx, ymx, t2d) in enumerate(ed.base_niels_affine()):
        assert [val(tab[k, j]) for j in range(4)] == [ypx, ymx, t2d, 2]
    tail = c[16 * 4 * 10 :].reshape(3, 10)
    assert [val(t) for t in tail] == [ref.D, ed.D2, ref.SQRT_M1]
    # the niels table is the plain version's fixed-base table, re-encoded
    tab13 = ed._base_niels_table_np()
    for k, (ypx, ymx, t2d) in enumerate(ed.base_niels_affine()):
        assert [ed.fe.limbs_to_int(tab13[j, k]) for j in range(3)] == [ypx, ymx, t2d]


def test_wrapper_routes_cpu_tensors_to_plain_version():
    packed = torch.from_numpy(_lanes(8, seed=2))
    launches, plain = ec.launches, ed.plain_calls
    got = ec.verify_packed(packed)
    assert ec.launches == launches and ed.plain_calls == plain + 1
    assert got.dtype == torch.bool and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), ed._verify_packed(packed).numpy())
    with pytest.raises(ValueError):
        ec.verify_packed(packed.to("meta"))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    _need_card()
    packed = torch.from_numpy(_lanes(512, seed=4)).cuda()
    launches = ec.launches
    got = ec.verify_packed(packed)
    torch.cuda.synchronize()
    assert ec.launches == launches + 1
    plain = ed._verify_packed(packed)
    assert torch.equal(got, plain)
    assert ec.geometry() == (_GROUP, _BLOCK)
    with pytest.raises(ValueError):
        ec.verify_packed(packed[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        ec.verify_packed(packed[:64].contiguous())  # not 128 rows


@pytest.mark.cuda
def test_kernel_on_card_edge_lanes_and_ragged_counts():
    _need_card()
    cols, want = [], []
    for case in ("y_is_p", "y_is_p_plus_1", "y_ge_p_signed", "x0_sign", "sign_flipped", "torsion"):
        c, w = _edge_lanes(case)
        cols += c
        want += w
    got = ec.verify_packed(torch.from_numpy(_pack(cols)).cuda())
    assert got.cpu().tolist() == want
    packed = torch.from_numpy(_lanes(64, seed=8)).cuda()
    plain = ed._verify_packed(packed)
    for n in (1, 3, 33, 47):
        got = ec.verify_packed(packed[:, :n].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(got, plain[:n]), n


@pytest.mark.cuda
def test_batch_verifier_streams_on_card():
    """Two stager threads, each on its own CUDA stream, five chunks in
    flight through pinned staging buffers: verdicts by construction."""
    _need_card()
    rng = random.Random(6)
    items, want = [], []
    for i in range(600):
        sk = SecretKey.pseudo_random_for_testing(i)
        msg = b"streams %d" % i
        sig = bytearray(sk.sign(msg))
        if i % 7 == 3:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        items.append((sk.public_raw, msg, bytes(sig)))
        want.append(i % 7 != 3)
    bv = ed.BatchVerifier(max_batch=128, streams=2)
    launches, plain = ec.launches, ed.plain_calls
    assert bv.verify(items) == want
    assert bv.verify(items) == want  # pooled buffers reused
    assert ec.launches == launches + 10 and ed.plain_calls == plain
    encs = [it[0] for it in items[:5]] + [ref.small_order_blacklist()[2], b"\x02" * 32]
    want_t = [True] * 5 + [
        ref.decompress(e) is not None and ref.is_torsion_free(ref.decompress(e))
        for e in encs[5:]
    ]
    assert bv.verify_torsion(encs) == want_t
