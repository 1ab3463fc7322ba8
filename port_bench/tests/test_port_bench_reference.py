"""The frozen reference verifier and the traffic generator's lanes, on the
CPU: RFC 8032's test vectors, each bad-lane class, libsodium's blacklist,
and agreement with the port's own pure-Python oracle and, where it loads,
libsodium."""

import hashlib
import random

import pytest

from port_bench import generator
from port_bench.reference import ed25519 as ref

# RFC 8032 section 7.1, TESTS 1-3: secret key, public key, message, signature
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032)
def test_rfc8032_vectors(sk, pk, msg, sig):
    pk, msg, sig = bytes.fromhex(pk), bytes.fromhex(msg), bytes.fromhex(sig)
    assert generator._sign(bytes.fromhex(sk), msg) == (pk, sig)
    assert ref.verify(pk, msg, sig) and ref.verify_lax(pk, msg, sig)
    assert not ref.verify(pk, msg + b"\x00", sig)
    assert not ref.verify(pk, msg, sig[:63] + bytes([sig[63] ^ 1]))


def _lane(cls, i=5, seed=7, msg_bytes=32):
    return generator.make_lane((generator.master(seed), i, cls, msg_bytes))


# class -> (passes the input gate, strict verdict, lax verdict)
CLASSES = {
    generator.GOOD: (True, True, True),
    "flipped_sig_bit": (True, False, False),
    "noncanonical_s": (False, False, True),
    "small_order_a": (False, False, True),
}


@pytest.mark.parametrize("cls", sorted(CLASSES))
@pytest.mark.parametrize("i", [0, 1, 2, 3, 4, 5, 6, 7])
def test_bad_lane_classes(cls, i):
    pk, msg, sig = _lane(cls, i)
    gate, strict, lax = CLASSES[cls]
    assert len(pk) == 32 and len(msg) == 32 and len(sig) == 64
    assert ref.gate(pk, sig) == gate
    assert ref.verify(pk, msg, sig) == strict
    assert ref.verify_lax(pk, msg, sig) == lax


def test_small_order_encodings_are_libsodiums_blacklist():
    so = ref.small_order_encodings()
    assert len(so) == 7  # five y-values of the 8-torsion points, p and p + 1
    assert ref.P.to_bytes(32, "little") in so and (ref.P + 1).to_bytes(32, "little") in so
    assert (1).to_bytes(32, "little") in so and bytes(32) in so
    for pt in ref.torsion_points():
        assert ref.point_eq(ref.scalar_mult(8, pt), ref.IDENTITY)
        assert ref.has_small_order(ref.encode(pt))
    # the sign bit is ignored, as libsodium's compare does
    assert ref.has_small_order(bytes(31) + b"\x80")


def test_gate_rules_one_by_one():
    pk, msg, sig = _lane(generator.GOOD)
    s = int.from_bytes(sig[32:], "little")
    assert not ref.gate(pk, sig[:32] + (s + ref.L).to_bytes(32, "little"))   # S >= L
    assert not ref.gate(pk, (1).to_bytes(32, "little") + sig[32:])           # small-order R
    assert not ref.gate((ref.P + 2).to_bytes(32, "little"), sig)             # y >= p
    assert not ref.gate(bytes(32), sig)                                      # small-order A
    assert not ref.gate(pk[:31], sig) and not ref.gate(pk, sig[:63])
    # a non-canonical R passes the gate but never verifies
    r_alias = (ref.P + 3).to_bytes(32, "little")
    assert ref.gate(pk, r_alias + sig[32:]) and not ref.verify(pk, msg, r_alias + sig[32:])


def test_agrees_with_the_ports_oracle_and_libsodium():
    from stellar_tpu_torch.crypto import sodium
    from stellar_tpu_torch.ops import ref25519 as port_ref

    assert ref.small_order_encodings() == frozenset(port_ref.small_order_blacklist())
    rng = random.Random(11)
    lanes = [_lane(c, i) for i, c in enumerate(sorted(CLASSES) * 3)]
    for pk, msg, sig in list(lanes):
        b = bytearray(sig)
        b[rng.randrange(64)] ^= 1 << rng.randrange(8)
        lanes.append((pk, msg, bytes(b)))
    lanes.append((bytes(32), b"", bytes(64)))
    for pk, msg, sig in lanes:
        want = ref.verify(pk, msg, sig)
        assert port_ref.verify(pk, msg, sig) == want
        if sodium.available():
            assert sodium.verify_detached(sig, msg, pk) == want


def test_lanes_are_fixed_by_the_seed():
    assert _lane("small_order_a", 3, seed=1) == _lane("small_order_a", 3, seed=1)
    assert _lane(generator.GOOD, 3, seed=1) != _lane(generator.GOOD, 3, seed=2)
    # large seeds, past 32 signed bits, and negative ones are whole numbers too
    assert generator.master(2**40 + 1) != generator.master(2**40 + 2)
    assert generator.master(-5) == hashlib.sha512(b"port_bench seed -5").digest()


def test_both_signing_paths_give_the_same_bytes():
    fast = generator._fast_sign()
    if fast is None:  # the pure-Python path is the only one here
        return
    m = generator.master(2**35 + 3)
    for i in range(12):
        for cls in sorted(CLASSES):
            assert generator.make_lane((m, i, cls, 32), fast) == generator.make_lane((m, i, cls, 32))
