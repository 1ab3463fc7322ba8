"""The port's curve layer and plain verify kernel (stellar_tpu_torch/ops/
ed25519.py) against the JAX package's (stellar_tpu/ops/ed25519.py).

- point ops: limb for limb against the JAX ones, and against ref25519;
- the fixed parameters the two share (the fixed-base niels table, SUB_PAD,
  d, 2d, sqrt(-1), the small-order blacklist): equal;
- the port's copy of ref25519 agrees with the JAX package's on decoding and
  the strict gate over random and hostile encodings;
- verify_kernel: verdict for verdict against the JAX verify_kernel (jit,
  CPU) at N = 16, the shape of __graft_entry__.entry(), on its mixed lanes
  and on raw lanes the host gate would reject (y >= p, s >= L, small-order
  and torsion-proof lanes).

Tolerance: exact everywhere (integer arithmetic, boolean verdicts).
"""

import hashlib
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from stellar_tpu.ops import ed25519 as jed  # noqa: E402
from stellar_tpu.ops import fe as jfe  # noqa: E402
from stellar_tpu.ops import ref25519 as jref  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from stellar_tpu_torch.ops import fe as tfe  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as tref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

P = jref.P


@pytest.fixture(scope="module")
def points():
    rng = random.Random(11)
    pts = []
    while len(pts) < 6:
        y = rng.randrange(P)
        enc = int.to_bytes(y | (rng.randrange(2) << 255), 32, "little")
        pt = jref.decompress(enc)
        if pt is not None:
            pts.append(pt)
    return pts


def _np_point(pts):
    return tuple(
        np.stack([jfe.int_to_limbs(p[c] % P) for p in pts], axis=1) for c in range(4)
    )


def _jax(pt):
    return tuple(jnp.asarray(c) for c in pt)


def _torch(pt):
    return tuple(torch.from_numpy(c) for c in pt)


def _assert_same(jax_out, torch_out):
    if isinstance(jax_out, tuple):
        assert len(jax_out) == len(torch_out)
        for j, t in zip(jax_out, torch_out):
            _assert_same(j, t)
        return
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


def _host(pt, i):
    return tuple(jfe.limbs_to_int(np.asarray(pt[c])[:, i]) % P for c in range(4))


@pytest.mark.parametrize("need_t", [True, False])
def test_point_ops_limb_exact(points, need_t):
    a = _np_point(points)
    b = _np_point(points[::-1])
    niels_j = jax.jit(jed.to_niels)(_jax(b))
    niels_t = ted.to_niels(_torch(b))
    _assert_same(niels_j, niels_t)
    _assert_same(jax.jit(jed.point_add)(_jax(a), _jax(b)), ted.point_add(_torch(a), _torch(b)))
    _assert_same(
        jax.jit(lambda p, n: jed.point_add_niels(p, n, need_t=need_t))(_jax(a), niels_j),
        ted.point_add_niels(_torch(a), niels_t, need_t=need_t),
    )
    _assert_same(
        jax.jit(lambda p: jed.point_double(p, need_t=need_t))(_jax(a)),
        ted.point_double(_torch(a), need_t=need_t),
    )
    _assert_same(jax.jit(jed.point_negate)(_jax(a)), ted.point_negate(_torch(a)))


def test_point_ops_vs_oracle(points):
    a = _torch(_np_point(points))
    add = ted.point_add(a, a)
    dbl = ted.point_double(a)
    ident = ted.point_add(a, ted.point_identity(len(points)))
    for i, p in enumerate(points):
        want = tref.point_add(p, p)
        assert tref.point_equal(_host(add, i), want)
        assert tref.point_equal(_host(dbl, i), want)
        assert tref.point_equal(_host(ident, i), p)


def test_compress_decompress_limb_exact(points):
    a = _np_point(points)
    enc_j = np.asarray(jax.jit(jed.compress)(_jax(a)))
    enc_t = ted.compress(_torch(a)).numpy()
    np.testing.assert_array_equal(enc_t, enc_j)
    for i, p in enumerate(points):
        assert bytes(enc_t[:, i].astype(np.uint8)) == tref.compress(p)
    # decompress: the encodings plus hostile y values (non-square, x = 0
    # with the sign bit set, y >= p)
    rng = random.Random(3)
    encs = [bytes(enc_t[:, i].astype(np.uint8)) for i in range(len(points))]
    encs += [rng.getrandbits(256).to_bytes(32, "little") for _ in range(4)]
    encs += [(1 | (1 << 255)).to_bytes(32, "little"), (P + 1).to_bytes(32, "little")]
    by = np.stack([np.frombuffer(e, np.uint8).astype(np.int32) for e in encs], axis=1)
    sign = by[31] >> 7
    by[31] &= 0x7F
    y_j = jfe.limbs_from_bytes(jnp.asarray(by))
    (pt_j, fail_j) = jax.jit(jed.decompress)(y_j, jnp.asarray(sign))
    y_t = tfe.limbs_from_bytes(torch.from_numpy(by))
    (pt_t, fail_t) = ted.decompress(y_t, torch.from_numpy(sign))
    _assert_same(pt_j, pt_t)
    np.testing.assert_array_equal(fail_t.numpy(), np.asarray(fail_j))
    for i, e in enumerate(encs):
        assert bool(fail_t[i]) == (tref.decompress(e) is None)


def test_shared_constants_equal():
    np.testing.assert_array_equal(ted._base_niels_table_np(), jed._base_niels_table_np())
    np.testing.assert_array_equal(ted._BASE_TABLE.numpy(), np.asarray(jed._BASE_TABLE))
    np.testing.assert_array_equal(tfe.SUB_PAD.numpy(), np.asarray(jfe.SUB_PAD))
    assert (ted.D, ted.D2, ted.SQRT_M1, ted.L) == (jed.D, jed.D2, jed.SQRT_M1, jed.L)
    for t, j in ((ted._D_FE, jed._D_FE), (ted._D2_FE, jed._D2_FE), (ted._SQRT_M1_FE, jed._SQRT_M1_FE)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tref.small_order_blacklist() == jref.small_order_blacklist()
    assert ted._BLACKLIST == jed._BLACKLIST
    assert tref.base_point() == jref.base_point()


def test_ref25519_copy_agrees():
    rng = random.Random(21)
    sk_seed = hashlib.sha256(b"ref copy").digest()
    sig = tref.sign_with_seed(sk_seed, b"m")
    assert sig == jref.sign_with_seed(sk_seed, b"m")
    pk_t = tref.compress(tref.scalar_mult(
        (int.from_bytes(hashlib.sha512(sk_seed).digest()[:32], "little")
         & ((1 << 254) - 8)) | (1 << 254), tref.base_point()))
    assert tref.verify(pk_t, b"m", sig) and jref.verify(pk_t, b"m", sig)
    encs = [rng.getrandbits(256).to_bytes(32, "little") for _ in range(24)]
    encs += list(jref.small_order_blacklist()) + [(P + k).to_bytes(32, "little") for k in range(3)]
    for e in encs:
        assert tref.decompress(e) == jref.decompress(e)
        assert tref.has_small_order(e) == jref.has_small_order(e)
    pk = np.stack([np.frombuffer(e, np.uint8) for e in encs])
    sg = np.stack([np.frombuffer(encs[(i + 1) % len(encs)] + e, np.uint8) for i, e in enumerate(encs)])
    np.testing.assert_array_equal(
        tref.strict_input_ok_batch(pk, sg), jref.strict_input_ok_batch(pk, sg)
    )


def _raw_lanes():
    """16 raw lanes (A, R, s, h) the host gate would reject, or that only
    the unsigned-window arithmetic decides: y >= p (incl. the identity's
    alias p + 1 with R := enc(s·B), which verifies), s >= L on a valid
    signature (verifies: the modular identity), small-order A and R,
    torsion-proof lanes (A := P, s := 0, h := L, R := identity), bytes."""
    rng = random.Random(99)
    B = tref.base_point()
    lanes = []
    for i in range(16):
        seed = hashlib.sha256(b"raw lane %d" % i).digest()
        msg = b"raw %d" % i
        sig = tref.sign_with_seed(seed, msg)
        a = int.from_bytes(hashlib.sha512(seed).digest()[:32], "little")
        a = (a & ((1 << 254) - 8)) | (1 << 254)
        pk = tref.compress(tref.scalar_mult(a, B))
        A, R, S = pk, sig[:32], sig[32:]
        H = None
        k = i % 8
        if k == 0:
            s = rng.randrange(tref.L)
            A = (P + 1).to_bytes(32, "little")
            R = tref.compress(tref.scalar_mult(s, B))
            S = s.to_bytes(32, "little")
        elif k == 1:
            A = ((P + rng.randrange(19)) | (rng.randrange(2) << 255)).to_bytes(32, "little")
        elif k == 2:
            S = (int.from_bytes(S, "little") + tref.L).to_bytes(32, "little")
        elif k == 3:
            S = (int.from_bytes(S, "little") + 7 * tref.L).to_bytes(32, "little")
        elif k == 4:
            A = rng.choice(tref.small_order_blacklist())
        elif k == 5:
            R = rng.choice(tref.small_order_blacklist())
        elif k == 6:
            A = pk if i < 8 else tref.small_order_blacklist()[2]
            R, S, H = b"\x01" + bytes(31), bytes(32), tref.L.to_bytes(32, "little")
        else:
            A, R, S, H = (rng.getrandbits(256).to_bytes(32, "little") for _ in range(4))
        if H is None:
            h = int.from_bytes(hashlib.sha512(R + A + msg).digest(), "little") % tref.L
            H = h.to_bytes(32, "little")
        lanes.append((A, R, S, H))
    return lanes


def _packed(lanes):
    p = np.zeros((128, len(lanes)), dtype=np.uint8)
    for i, cols in enumerate(lanes):
        for r, c in enumerate(cols):
            p[32 * r : 32 * r + 32, i] = np.frombuffer(c, np.uint8)
    return p


def _mixed_lanes():
    items, want = graft._mixed_lane_items(16)
    lanes = []
    for pk, msg, sig in items:
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % tref.L
        lanes.append((pk, sig[:32], sig[32:], h.to_bytes(32, "little")))
    return lanes, want


@pytest.fixture(scope="module")
def jax_kernel():
    return jax.jit(jed.verify_kernel)


@pytest.mark.parametrize("case", ["mixed", "raw"])
def test_verify_kernel_matches_jax(jax_kernel, case):
    if case == "mixed":
        lanes, want = _mixed_lanes()
    else:
        lanes, want = _raw_lanes(), None
    p = _packed(lanes)
    a, r = p[0:32].astype(np.int32), p[32:64].astype(np.int32)
    s_n = jed._nibbles_np(np.ascontiguousarray(p[64:96].T))
    h_n = jed._nibbles_np(np.ascontiguousarray(p[96:128].T))
    j = np.asarray(jax_kernel(*(jnp.asarray(x) for x in (a, r, s_n, h_n))))
    t = ted.verify_kernel(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (a, r, s_n, h_n)))
    np.testing.assert_array_equal(t.numpy(), j)
    # the packed entry point gives the same verdicts as the unpacked kernel
    np.testing.assert_array_equal(ted._verify_packed(torch.from_numpy(p)).numpy(), j)
    if want is not None:
        np.testing.assert_array_equal(j, want)
    else:
        # both verdict classes, and the lanes that must verify do
        assert j[[0, 2, 3, 8, 10, 11]].all() and not j.all()
        assert bool(j[6]) and not bool(j[14])  # torsion: prime-order vs small-order
