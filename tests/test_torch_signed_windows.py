"""The signed-digit windows of the verify kernel (``STELLAR_TPU_SIGNED_WINDOWS``)
and the verify-plane knobs the port reads as the JAX package does.

- The plain version with ``signed=True`` against the JAX package's
  ``verify_kernel_pallas(signed=True)`` (interpret mode) on one 512-lane tile:
  the JAX package's mixed lanes, the RFC 8032 vectors, R-edge and torsion
  lanes, and raw lanes with s or h at or above 0x77…78 (``RAW_CARRY``),
  where the recode drops the carry out of window 63 and the signed and
  unsigned kernels part.
- Signed == unsigned == the JAX XLA ``verify_kernel`` on lanes that pass the
  gate; the recode's digits; the CUDA source's two signed kernels (the
  wide variant and the pair) built as host C++ (``tests/torch_host_cuda.py``,
  block emulation) against the signed plain version; the knob through ``BatchVerifier`` on the host-hash,
  device-hash and torsion paths.
- The knobs ``STELLAR_TPU_NATIVE_SIGHASH`` (``native_hash``),
  ``STELLAR_TPU_SIGHASH_THREADS``, ``STELLAR_TPU_HOST_ASSIST`` and
  ``STELLAR_TPU_VERIFY_STREAMS``: each parses to the JAX ``BatchVerifier``'s
  attribute under the same environment; the Python host stage equals the C
  one byte for byte; a host assist without libsodium refuses to build.
- The pair (the signed windows' narrow-launch kernel): its comb against
  ref25519's k·16^i·B and the JAX package's base table, and the width rule
  ``signed_variant``.
- ``cuda``: both signed kernels on the card against the signed plain
  version (skips without a card).

JAX is imported inside fixtures only: the card's machine has none.
Tolerance: exact (boolean verdicts, staged bytes).
"""

import ctypes
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stellar_tpu_torch import native as tnative  # noqa: E402
from stellar_tpu_torch.crypto import SecretKey, sodium  # noqa: E402
from stellar_tpu_torch.crypto.sigbackend import GpuSigBackend  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from stellar_tpu_torch.ops import ed25519_cuda as ec  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as ref  # noqa: E402
from stellar_tpu_torch.ops import sha512 as tsha  # noqa: E402
from test_torch_ed25519_cuda import _edge_lanes, _enc, _h, _lanes, _pack  # noqa: E402
from torch_host_cuda import build_host_kernel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

# the least 256-bit value whose signed recode carries out of window 63
RAW_CARRY = 2**256 - int("88" * 32, 16)
EDGE_CASES = ("y_is_p", "y_is_p_plus_1", "y_ge_p_signed", "x0_sign", "sign_flipped", "torsion")
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60", b""),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb", b"\x72"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7", b"\xaf\x82"),
]

_HOST_LOOP = r"""
extern "C" void host_verify(const uint8_t *p, uint8_t *out, int n,
                            const int32_t *consts, int signed_windows) {
    host_launch((n + 15) / 16, 64, 4, [&] {
        if (signed_windows) ed25519_verify_kernel<true>(p, out, n, consts);
        else ed25519_verify_kernel<false>(p, out, n, consts);
    });
}
extern "C" void host_verify_pair(const uint8_t *p, uint8_t *out, int n,
                                 const int32_t *consts, const int32_t *comb) {
    host_launch((n + kPairSigs - 1) / kPairSigs, 64, 4, [&] {
        ed25519_verify_signed_pair_kernel(p, out, n, consts, comb);
    });
}
"""


def _cols(items):
    """(A, R, s, h = SHA-512(R‖A‖M) mod L) columns of signed triples."""
    return [(pk, sig[:32], sig[32:], _h(sig[:32], pk, msg)) for pk, msg, sig in items]


def _rfc_items():
    out = []
    for seed_hex, msg in RFC8032:
        sk = SecretKey.from_seed(bytes.fromhex(seed_hex))
        out.append((sk.public_raw, msg, sk.sign(msg)))
    return out


def _raw_carry_cols(n=16):
    """Valid signatures with s (or, every fourth lane, h) raised by a
    multiple of L to a raw value >= RAW_CARRY: the unsigned kernel accepts
    them (the modular identity), the signed one drops the window-63 carry.
    The first lanes have s >= 2^255."""
    cols = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(500 + i)
        msg = b"raw carry %d" % i
        sig = sk.sign(msg)
        A, R, S = sk.public_raw, sig[:32], sig[32:]
        H = _h(R, A, msg)
        col = 3 if i % 4 == 3 else 2
        v = int.from_bytes((A, R, S, H)[col], "little")
        k = max(k for k in range(16) if v + k * ref.L < 2**256)
        k -= i % 3 if i >= 4 else 0  # vary the top nibble, keeping >= RAW_CARRY
        raised = v + k * ref.L
        assert raised >= RAW_CARRY and (i >= 2 or raised >= 2**255)
        cols.append(tuple(_enc(raised) if c == col else x for c, x in enumerate((A, R, S, H))))
    return cols


def _edge_cols():
    cols, want = [], []
    for case in EDGE_CASES:
        c, w = _edge_lanes(case)
        cols += c
        want += w
    return cols, want


def _plain(packed, signed):
    return ted._verify_packed(torch.from_numpy(np.ascontiguousarray(packed)), signed=signed).numpy()


# -- the plain version ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ops():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from stellar_tpu.ops import ed25519 as jed
    from stellar_tpu.ops import ed25519_pallas as jpal

    return jax, jnp, jed, jpal


def test_signed_plain_matches_jax_pallas_signed_on_a_tile(jax_ops):
    """One NT-lane tile through verify_kernel_pallas(signed=True) in
    interpret mode and through the port's signed plain version: verdict for
    verdict, raw-carry lanes included (where the unsigned kernel accepts)."""
    import __graft_entry__ as graft

    _, jnp, _, jpal = jax_ops
    mixed, mixed_want = graft._mixed_lane_items(256)
    raw = _raw_carry_cols()
    edge, edge_want = _edge_cols()
    cols = _cols(mixed) + _cols(_rfc_items()) + raw + edge
    packed = np.concatenate([_pack(cols), _lanes(jpal.NT - len(cols), seed=31)], axis=1)
    assert packed.shape[1] == jpal.NT
    got = _plain(packed, signed=True)
    want = np.asarray(jpal.verify_kernel_pallas(
        *(jnp.asarray(packed[r : r + 32]) for r in (0, 32, 64, 96)), interpret=True, signed=True))
    np.testing.assert_array_equal(got, want)
    n_mixed, n_raw = len(mixed), len(raw)
    np.testing.assert_array_equal(got[:n_mixed], mixed_want)
    assert got[n_mixed : n_mixed + 3].all()  # RFC 8032
    lo = n_mixed + 3
    assert not got[lo : lo + n_raw].any() and _plain(packed[:, lo : lo + n_raw], signed=False).all()
    assert got[lo + n_raw : len(cols)].tolist() == edge_want
    assert got.any() and not got.all()


def test_signed_equals_unsigned_and_jax_xla_on_gated_lanes(jax_ops):
    """On lanes that pass the gate both window forms give libsodium's
    verdict, as the JAX test claims of its two kernels; the JAX side is its
    XLA verify_kernel at N = 16."""
    import __graft_entry__ as graft

    jax, jnp, jed, _ = jax_ops
    items = graft._mixed_lane_items(13)[0] + _rfc_items()
    want = np.array([sodium.verify_detached(s, m, p) for p, m, s in items])
    packed = _pack(_cols(items))
    xla = np.asarray(jax.jit(jed.verify_kernel)(
        jnp.asarray(packed[0:32].astype(np.int32)), jnp.asarray(packed[32:64].astype(np.int32)),
        jnp.asarray(jed._nibbles_np(packed[64:96].T)), jnp.asarray(jed._nibbles_np(packed[96:128].T))))
    np.testing.assert_array_equal(xla, want)
    np.testing.assert_array_equal(_plain(packed, signed=False), want)
    np.testing.assert_array_equal(_plain(packed, signed=True), want)
    assert want.any() and not want.all()


def test_signed_and_unsigned_part_on_raw_carry_lanes():
    raw = _raw_carry_cols()
    packed = _pack(raw)
    assert int.from_bytes(raw[0][2], "little") >= 2**255
    assert _plain(packed, signed=False).all()
    assert not _plain(packed, signed=True).any()


def _recode_values():
    rng = random.Random(17)
    edge = [0, 1, 7, 8, 15, 16, ref.L, ref.L - 1, 8 * ref.L, 2**253 - 1, 2**255,
            RAW_CARRY - 1, RAW_CARRY, 2**256 - 1, int("77" * 32, 16), int("88" * 32, 16)]
    return edge + [rng.getrandbits(256) for _ in range(256)] + [rng.randrange(ref.L) for _ in range(64)]


def test_recode_digits_lie_in_range_and_sum_to_the_scalar():
    vals = _recode_values()
    nibs = torch.tensor([[(v >> (4 * t)) & 15 for v in vals] for t in range(64)], dtype=torch.int32)
    digits = ted._recode_signed(nibs)
    assert digits.dtype == torch.int32 and digits.shape == nibs.shape
    assert int(digits.min()) >= -8 and int(digits.max()) <= 7
    for j, v in enumerate(vals):
        c64 = int(v >= RAW_CARRY)
        assert sum(int(digits[t, j]) << (4 * t) for t in range(64)) == v - (c64 << 256), hex(v)
        if v < ref.L:
            assert c64 == 0


# -- the CUDA source's signed instance, as host C++ --------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    lib = build_host_kernel(ec.SOURCE, _HOST_LOOP, tmp_path_factory.mktemp("signed_host"), threads=True)
    lib.host_verify.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.host_verify.restype = None
    lib.host_verify_pair.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.host_verify_pair.restype = None
    return lib


def _host_verify(lib, packed, signed, variant="wide"):
    """The source's kernel over ``packed`` under the block emulation: the
    unsigned instance, or for ``signed`` the variant named."""
    packed = np.ascontiguousarray(packed)
    consts = ec.kernel_constants()
    out = np.full(packed.shape[1], 7, dtype=np.uint8)  # every lane must be written
    if signed and variant == "pair":
        comb = ec.comb_table()
        lib.host_verify_pair(packed.ctypes.data, out.ctypes.data, packed.shape[1], consts.ctypes.data,
                             comb.ctypes.data)
    else:
        lib.host_verify(packed.ctypes.data, out.ctypes.data, packed.shape[1], consts.ctypes.data,
                        int(signed))
    assert set(out.tolist()) <= {0, 1}, out
    return out.astype(bool)


def _host_case(case):
    if case == "mixed":
        return _lanes(64, seed=8)
    if case == "r_edge":
        return _pack(_edge_cols()[0])
    if case == "raw_carry":
        return _pack(_raw_carry_cols())
    return _lanes(64, seed=8)[:, : int(case.split("_")[1])]


@pytest.mark.parametrize("case", ["mixed", "r_edge", "raw_carry", "ragged_1", "ragged_3", "ragged_33"])
@pytest.mark.parametrize("variant", ec.SIGNED_VARIANTS)
def test_kernel_source_signed_instance_matches_plain(host_kernel, variant, case):
    packed = _host_case(case)
    plain = _plain(packed, signed=True)
    np.testing.assert_array_equal(_host_verify(host_kernel, packed, signed=True, variant=variant), plain)
    if case == "raw_carry":
        # the unsigned instance of the same source keeps its verdicts there
        unsigned = _host_verify(host_kernel, packed, signed=False)
        assert unsigned.all() and not plain.any()
        np.testing.assert_array_equal(unsigned, _plain(packed, signed=False))


# -- the pair's comb and the variant rule --------------------------------------


def _limbs_value(limbs):
    """The kernel's 10 limbs (radix 2^25.5) -> their value mod p."""
    return sum(int(v) << ((i * 51 + 1) // 2) for i, v in enumerate(limbs)) % ref.P


@pytest.fixture(scope="module")
def jax_base_table():
    pytest.importorskip("jax")
    from stellar_tpu.ops import ed25519 as jed
    from stellar_tpu.ops import fe as jfe

    return np.asarray(jed._BASE_TABLE), jfe.limbs_to_int


def test_comb_table_holds_k_times_16_to_the_i_times_b(jax_base_table):
    """Every entry [i][k−1] of the pair's comb is k·16^i·B in affine niels
    form (y+x, y−x, 2d·x·y), from ref25519's scalar multiplication; row i = 0
    is also the JAX package's fixed-base table at k = 1..8."""
    comb = ec.comb_table()
    assert comb.shape == (64, 8, 3, 10) and comb.dtype == np.int32 and comb.nbytes == 61440
    B = ref.base_point()
    for i in range(64):
        for k in range(1, 9):
            x, y, z, _ = ref.scalar_mult(k << (4 * i), B)
            zinv = ref.fe_inv(z)
            xa, ya = x * zinv % ref.P, y * zinv % ref.P
            want = ((ya + xa) % ref.P, (ya - xa) % ref.P, 2 * ref.D * xa * ya % ref.P)
            assert tuple(_limbs_value(comb[i, k - 1, c]) for c in range(3)) == want, (i, k)
    jtab, limbs_to_int = jax_base_table
    for k in range(1, 9):
        for c in range(3):
            assert _limbs_value(comb[0, k - 1, c]) == limbs_to_int(jtab[c, k]) % ref.P, (k, c)


def test_signed_variant_picks_the_pair_up_to_two_blocks_an_sm():
    """The rule: the pair up to PAIR_MAX_LANES lanes (two pair blocks on
    each of the H100's 132 SMs), the wide variant past it; a forced variant
    must name one of the signed windows' kernels."""
    assert ec.SIGNED_VARIANTS == ("wide", "pair") and ec.PAIR_MAX_LANES == 2112
    edge = ec.PAIR_MAX_LANES
    picks = {n: ec.signed_variant(n) for n in (1, 3, 16, 64, 300, 904, edge, edge + 1, 4096, 32768)}
    assert picks == {1: "pair", 3: "pair", 16: "pair", 64: "pair", 300: "pair", 904: "pair",
                     edge: "pair", edge + 1: "wide", 4096: "wide", 32768: "wide"}
    packed = torch.from_numpy(_pack(_raw_carry_cols(2)))
    for variant in ec.SIGNED_VARIANTS:
        assert not ec.verify_packed(packed, signed=True, variant=variant).any()
    with pytest.raises(ValueError, match="no variant"):
        ec.verify_packed(packed, signed=False, variant="pair")
    with pytest.raises(ValueError, match="no variant"):
        ec.verify_packed(packed, signed=True, variant="lane")


# -- the knob through the verify plane ----------------------------------------


def _plane_items():
    """Signed triples with messages of 0-120 bytes (single- and multi-block
    under device hashing), corrupted signatures, and lanes the gate
    refuses (s >= L, a small-order key, short fields)."""
    rng = random.Random(23)
    items = []
    for i in range(40):
        sk = SecretKey.pseudo_random_for_testing(300 + i)
        msg = rng.randbytes(rng.choice((0, 5, 32, 47, 48, 64, 111, 120)))
        sig = bytearray(sk.sign(msg))
        if i % 5 == 1:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        items.append((sk.public_raw, msg, bytes(sig)))
    pk, msg, sig = items[0]
    items += [
        (pk, msg, sig[:32] + ref.L.to_bytes(32, "little")),
        (pk, msg, sig[:32] + (2**256 - 1).to_bytes(32, "little")),
        (ref.small_order_blacklist()[1], msg, sig),
        (pk[:31], msg, sig),
        (pk, msg, sig[:63]),
    ]
    return items


def _sodium(items):
    return [sodium.verify_detached(s, m, p) for p, m, s in items]


@pytest.mark.parametrize("device_hash", [False, True], ids=["host_hash", "device_hash"])
def test_knob_flows_through_the_verify_plane(monkeypatch, device_hash):
    """STELLAR_TPU_SIGNED_WINDOWS reaches the plain kernel on the
    host-hash, device-hash and torsion paths of BatchVerifier, with the
    same verdicts."""
    flags = []
    real = ted.verify_kernel

    def spy(*args, signed=False):
        flags.append(signed)
        return real(*args, signed=signed)

    monkeypatch.setattr(ted, "verify_kernel", spy)
    monkeypatch.setattr(ted, "_SIGNED_WIN", True)
    items = _plane_items()
    bv = ted.BatchVerifier(device="cpu", max_batch=64, device_hash=device_hash)
    assert bv.verify(items) == _sodium(items)
    torsion_cols, torsion_want = _edge_lanes("torsion")
    assert bv.verify_torsion([c[0] for c in torsion_cols]) == torsion_want
    assert flags == [True, True]


def test_knob_is_read_at_import():
    code = "from stellar_tpu_torch.ops import ed25519 as e; print(e._SIGNED_WIN)"
    out = {}
    for value in ("1", "0"):
        env = dict(os.environ, STELLAR_TPU_SIGNED_WINDOWS=value)
        r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                           timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr
        out[value] = r.stdout.strip()
    assert out == {"1": "True", "0": "False"}


def test_wrapper_routes_cpu_tensors_to_the_signed_plain_version(monkeypatch):
    packed = torch.from_numpy(_pack(_raw_carry_cols(4)))
    launches, signed_launches = ec.launches, ec.signed_launches
    assert ec.verify_packed(packed, signed=False).all()
    assert not ec.verify_packed(packed, signed=True).any()
    monkeypatch.setattr(ted, "_SIGNED_WIN", True)
    assert not ec.verify_packed(packed).any()
    assert (ec.launches, ec.signed_launches) == (launches, signed_launches)


# -- the knobs the JAX verifier reads -----------------------------------------


@pytest.mark.parametrize("device_hash,item_major", [(False, False), (True, False), (True, True)],
                         ids=["host_hash", "device_hash", "device_hash_item_major"])
def test_python_stage_equals_the_c_stage(device_hash, item_major):
    """_stage_py / _stage_py_raw against sighash.stage / stage_raw: the
    packed buffer, the gate verdicts and the reject count, byte for byte;
    item-major, the verifier's Python route (``_stage_into`` with the C
    stage off) against sighash.stage_rows, the flag-1 count too."""
    items = _plane_items()
    n, rows = len(items), tsha.DH_ROWS if device_hash else ted.ROWS
    c_stage = tnative.load_sighash()
    outs = []
    for python in (True, False):
        packed = np.full((n, rows) if item_major else (rows, n), 0xA5, dtype=np.uint8)
        ok = np.full(n, 9, dtype=np.uint8)
        flagged = None
        if item_major and python:
            bv = ted.BatchVerifier(device="cpu", max_batch=n, native_hash=False, device_hash=True)
            rejects, flagged = bv._stage_into(items, 0, n, torch.from_numpy(packed), ok)
        elif item_major:
            rejects, flagged = c_stage.stage_rows(items, 0, n, packed, ok, ted._BLACKLIST, 0)
        elif python:
            fn = ted.BatchVerifier._stage_py_raw if device_hash else ted.BatchVerifier._stage_py
            rejects = fn(items, 0, n, packed, ok)
        else:
            fn = c_stage.stage_raw if device_hash else c_stage.stage
            rejects = fn(items, 0, n, packed, ok, ted._BLACKLIST, 0)
        outs.append((packed.T if item_major else packed, ok, rejects, flagged))
    (p_py, ok_py, r_py, f_py), (p_c, ok_c, r_c, f_c) = outs
    np.testing.assert_array_equal(p_py, p_c)
    np.testing.assert_array_equal(ok_py, ok_c)
    assert r_py == r_c == len(items) - int(ok_c.sum()) and r_c >= 5
    if device_hash:  # both single-block (flag 1) and host-hashed (flag 0) lanes
        flags = p_c[tsha.ROW_FLAG][ok_c.astype(bool)]
        assert flags.any() and not flags.all()
    if item_major:
        assert f_py == f_c == int(flags.sum())


@pytest.mark.parametrize("device_hash", [False, True], ids=["host_hash", "device_hash"])
def test_native_sighash_zero_pins_the_python_stage(monkeypatch, device_hash):
    items = _plane_items()
    monkeypatch.setenv("STELLAR_TPU_NATIVE_SIGHASH", "0")
    bv = ted.BatchVerifier(device="cpu", max_batch=64, device_hash=device_hash)
    assert bv.stats()["native_host_stage"] is False
    assert bv.verify(items) == _sodium(items)
    monkeypatch.delenv("STELLAR_TPU_NATIVE_SIGHASH")
    assert ted.BatchVerifier(device="cpu").stats()["native_host_stage"] is True
    backend = GpuSigBackend(device="cpu", native_hash=False, device_hash=device_hash)
    assert backend.stats()["native_host_stage"] is False


_KNOBS = {
    "STELLAR_TPU_NATIVE_SIGHASH": ("0", "1", "", "no"),
    "STELLAR_TPU_SIGHASH_THREADS": ("0", "3", "", "junk", "-2"),
    "STELLAR_TPU_HOST_ASSIST": ("0.25", "2", "-1", "", "junk"),
    "STELLAR_TPU_VERIFY_STREAMS": ("1", "3", "0", "-2", "junk"),
}


def _knob_value(bv, knob):
    if knob == "STELLAR_TPU_NATIVE_SIGHASH":
        return bv._sighash is not None
    if knob == "STELLAR_TPU_SIGHASH_THREADS":
        return bv._hash_threads
    if knob == "STELLAR_TPU_HOST_ASSIST":
        return bv.host_assist
    return bv.streams


@pytest.mark.parametrize("knob,value", [(k, v) for k, vs in _KNOBS.items() for v in vs])
def test_env_knob_parses_as_the_jax_verifier_does(jax_ops, monkeypatch, knob, value):
    jed = jax_ops[2]
    monkeypatch.setenv(knob, value)
    got = {}
    for side, build in (("jax", lambda: jed.BatchVerifier(max_batch=64, backend="xla")),
                        ("port", lambda: ted.BatchVerifier(device="cpu", max_batch=64))):
        try:
            got[side] = _knob_value(build(), knob)
        except ValueError as e:  # junk streams: both refuse
            got[side] = type(e)
    assert got["port"] == got["jax"], got


def test_knobs_leave_the_verdicts_unchanged(monkeypatch):
    """Every knob away from its default at once, over two chunks on two
    stager threads with a host-assisted tail: libsodium's verdicts."""
    for knob, value in (("STELLAR_TPU_NATIVE_SIGHASH", "0"), ("STELLAR_TPU_SIGHASH_THREADS", "2"),
                        ("STELLAR_TPU_HOST_ASSIST", "0.25"), ("STELLAR_TPU_VERIFY_STREAMS", "2")):
        monkeypatch.setenv(knob, value)
    items = _plane_items()
    bv = ted.BatchVerifier(device="cpu", max_batch=20)
    assert (bv.host_assist, bv.streams, bv._hash_threads, bv.stats()["native_host_stage"]) == (0.25, 2, 2, False)
    assert bv.verify(items) == _sodium(items)
    assert bv.n_host_assist_items == len(items) // 4 and bv.n_device_calls == 2
    monkeypatch.setenv("STELLAR_TPU_NATIVE_SIGHASH", "1")
    c_stage = ted.BatchVerifier(device="cpu", max_batch=20)
    assert c_stage.stats()["native_host_stage"] is True and c_stage.verify(items) == _sodium(items)


def test_host_assist_without_libsodium_refuses_to_build(monkeypatch):
    def missing():
        raise RuntimeError("libsodium not found")

    monkeypatch.setattr(sodium, "_load", missing)
    with pytest.raises(ValueError, match="STELLAR_TPU_HOST_ASSIST"):
        ted.BatchVerifier(device="cpu", host_assist=0.5)
    monkeypatch.setenv("STELLAR_TPU_HOST_ASSIST", "0.3")
    with pytest.raises(ValueError, match="libsodium"):
        ted.BatchVerifier(device="cpu")
    with pytest.raises(ValueError, match="STELLAR_TPU_HOST_ASSIST"):
        GpuSigBackend(device="cpu")
    assert ted.BatchVerifier(device="cpu", host_assist=0.0).host_assist == 0.0
    monkeypatch.setenv("STELLAR_TPU_HOST_ASSIST", "junk")
    assert ted.BatchVerifier(device="cpu").host_assist == 0.0


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_signed_kernel_matches_signed_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    edge, edge_want = _edge_cols()
    raw = _raw_carry_cols()
    packed = torch.from_numpy(np.concatenate(
        [_lanes(512, seed=4), _pack(raw + _cols(_rfc_items()) + edge)], axis=1)).cuda()
    launches, signed_launches = ec.launches, ec.signed_launches
    got = ec.verify_packed(packed, signed=True, variant="wide")
    torch.cuda.synchronize()
    assert (ec.launches, ec.signed_launches) == (launches, signed_launches + 1)
    assert torch.equal(got, ted._verify_packed(packed, signed=True))
    assert got[-len(edge):].cpu().tolist() == edge_want
    lo = 512
    assert not got[lo : lo + len(raw)].any() and ec.verify_packed(packed, signed=False)[lo : lo + len(raw)].all()
    for n in (1, 3, 33, 47):
        part = packed[:, :n].contiguous()
        want = ted._verify_packed(part, signed=True)
        for variant in ec.SIGNED_VARIANTS:
            assert torch.equal(ec.verify_packed(part, signed=True, variant=variant), want), (n, variant)
    residency = ec.residency(True)
    assert sorted(residency) == sorted(ec.SIGNED_VARIANTS)
    for res in (ec.residency(False), *residency.values()):
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1, res
        assert res["blocks_per_sm"] <= min(res["blocks_by_shared"], res["blocks_by_registers"]), res


@pytest.mark.cuda
def test_signed_pair_matches_signed_plain_version_on_card():
    """The pair, forced and by the rule, at the node's narrow widths and at
    4096 lanes against the signed plain version; raw-carry lanes rejected;
    each launch counted as a pair launch only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    raw = _raw_carry_cols()
    mixed = np.tile(_lanes(256, seed=6), 16)
    packed = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([_pack(raw), mixed], axis=1)[:, :4096])).cuda()
    plain = ted._verify_packed(packed, signed=True)
    assert not plain[: len(raw)].any() and plain.any()
    for n in (1, 2, 3, 8, 16, 33, 64, 4096):
        part = packed[:, -n:].contiguous() if n < 16 else packed[:, :n].contiguous()
        want = plain[-n:] if n < 16 else plain[:n]
        counts = (ec.launches, ec.signed_launches, ec.signed_pair_launches)
        got = ec.verify_packed(part, signed=True, variant="pair")
        torch.cuda.synchronize()
        assert (ec.launches, ec.signed_launches, ec.signed_pair_launches) == (
            counts[0], counts[1], counts[2] + 1)
        assert torch.equal(got, want), n
        if n <= ec.PAIR_MAX_LANES:
            assert torch.equal(ec.verify_packed(part, signed=True), want), n
            assert ec.signed_pair_launches == counts[2] + 2
