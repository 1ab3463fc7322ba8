"""The port's libsodium-free seams, held against libsodium on this host.

Where libsodium does not load (the GPU machine), the port's node runs:
- X25519 for peer auth in pure Python (``stellar_tpu_torch/crypto/x25519.py``,
  behind ``crypto/sodium.py``'s ``scalarmult``/``scalarmult_base``), which
  must give libsodium's bytes and refuse what libsodium refuses (an all-zero
  shared secret: the low-order and zero public values);
- ``os.urandom`` for ``randombytes``;
- ``ref25519`` for signing and for the eager verify of ``PubKeyUtils``
  (``crypto/keys.py``), which must give libsodium's signatures and verdicts
  and count each eager ref25519 verify in ``keys.stats()``.

The vectors: RFC 7748 §5.2 and §6.1, 256 seeded pairs; RFC 8032 §7.1 TEST
1-3, seeded mutations and the adversarial lanes of tests/test_ed25519_tpu.py.
The libsodium side is the port's own binding and the JAX package's
``PubKeyUtils``.  Tolerance: exact — bytes equal, verdicts equal, the same
inputs refused.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from stellar_tpu.crypto import sodium as jsodium  # noqa: E402
from stellar_tpu.crypto.keys import PubKeyUtils as JPubKeyUtils  # noqa: E402
from stellar_tpu_torch.crypto import keys, sodium, x25519  # noqa: E402
from stellar_tpu_torch.crypto.keys import PubKeyUtils, SecretKey  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as ref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

if not jsodium.available():
    pytest.skip("libsodium is the oracle here and does not load", allow_module_level=True)

H = bytes.fromhex
P = 2**255 - 19


@pytest.fixture
def no_libsodium(monkeypatch):
    """The port's libsodium loader fails, as on the GPU machine."""

    def missing():
        raise RuntimeError("libsodium not found")

    monkeypatch.setattr(sodium, "_load", missing)
    assert not sodium.available()
    keys.reset_stats()
    yield
    keys.reset_stats()


def _sodium_dh(secret, public):
    try:
        return jsodium.scalarmult(secret, public)
    except RuntimeError:
        return None


def _pure_dh(secret, public):
    try:
        return x25519.scalarmult(secret, public)
    except RuntimeError:
        return None


# -- X25519 ---------------------------------------------------------------


@pytest.mark.parametrize("scalar,u,out", [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
])
def test_x25519_rfc7748_section_5_2(scalar, u, out, no_libsodium):
    assert sodium.scalarmult(H(scalar), H(u)) == H(out)
    assert jsodium.scalarmult(H(scalar), H(u)) == H(out)


def test_x25519_rfc7748_iterated():
    """§5.2's iteration: k, u = X25519(k, u), k, from k = u = 9."""
    k = u = (9).to_bytes(32, "little")
    for i in range(1000):
        k, u = x25519.scalarmult(k, u), k
        if i == 0:
            assert k == H("422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079")
    assert k == H("684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51")


def test_x25519_rfc7748_section_6_1(no_libsodium):
    from stellar_tpu_torch.crypto import ecdh

    a = H("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = H("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    pa, pb = ecdh.ecdh_derive_public(a), ecdh.ecdh_derive_public(b)
    assert pa == H("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert pb == H("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    k = H("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert sodium.scalarmult(a, pb) == sodium.scalarmult(b, pa) == k
    # the session key derivation above it, equal to the JAX package's
    from stellar_tpu.crypto import ecdh as jecdh

    assert ecdh.ecdh_derive_shared_key(a, pa, pb, True) == jecdh.ecdh_derive_shared_key(a, pa, pb, True)


def test_x25519_seeded_pairs_match_libsodium():
    """256 seeded (secret, public) pairs: random public bytes (on the curve
    or its twist, top bit set or not), and real public keys."""
    rng = np.random.default_rng(7748)
    for i in range(256):
        secret = rng.bytes(32)
        public = rng.bytes(32) if i % 2 else jsodium.scalarmult_base(rng.bytes(32))
        assert x25519.scalarmult_base(secret) == jsodium.scalarmult_base(secret)
        assert _pure_dh(secret, public) == _sodium_dh(secret, public)


def _low_order_us():
    """libsodium's blacklist: 0, 1, the two points of order 8, p - 1, p,
    p + 1 — and each with the ignored top bit set."""
    us = [(0).to_bytes(32, "little"), (1).to_bytes(32, "little"),
          H("e0eb7a7c3b41b8ae1656e3faf19fc46ada098deb9c32b1fd866205165f49b800"),
          H("5f9c95bca3508c24b1d0b1559c83ef5b04445cc4581c8e86d8224eddd09f1157")]
    us += [(P + d).to_bytes(32, "little") for d in (-1, 0, 1)]
    return us + [u[:31] + bytes([u[31] | 0x80]) for u in us]


@pytest.mark.parametrize("u", _low_order_us(), ids=lambda u: u.hex()[:8] + u.hex()[-2:])
def test_x25519_low_order_refused_as_libsodium_refuses(u, no_libsodium):
    rng = random.Random(u)
    for _ in range(4):
        secret = bytes(rng.getrandbits(8) for _ in range(32))
        assert _sodium_dh(secret, u) is None
        with pytest.raises(RuntimeError, match="weak public key"):
            sodium.scalarmult(secret, u)


def test_randombytes_without_libsodium(no_libsodium):
    a, b = sodium.randombytes(32), sodium.randombytes(32)
    assert len(a) == len(b) == 32 and a != b
    assert len(sodium.randombytes(12)) == 12


# -- signing and the eager verify ------------------------------------------

RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60", b""),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb", b"\x72"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7", b"\xaf\x82"),
]


def _lanes():
    """RFC 8032 §7.1 TEST 1-3, seeded mutations, and the adversarial lanes
    of tests/test_ed25519_tpu.py (small-order keys and R, s >= L, y >= p, a
    zero signature), plus short keys and signatures."""
    items = []
    for seed_hex, msg in RFC8032:
        pk, sk = jsodium.sign_seed_keypair(H(seed_hex))
        items.append((pk, msg, jsodium.sign_detached(msg, sk)))
    rng = random.Random(1234)
    for i in range(24):
        pk, sk = jsodium.sign_seed_keypair(bytes([i]) * 32)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 100)))
        sig = bytearray(jsodium.sign_detached(msg, sk))
        if i % 2:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        items.append((pk, msg, bytes(sig)))
    pk, sk = jsodium.sign_seed_keypair(bytes(32))
    msg = b"m"
    sig = jsodium.sign_detached(msg, sk)
    for e in ref.small_order_blacklist():
        items.append((e, msg, sig))
        items.append((pk, msg, e + sig[32:]))
    bad_s = (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    items.append((pk, msg, sig[:32] + bad_s))
    items.append(((2**255 - 5).to_bytes(32, "little"), msg, sig))
    items.append((pk, msg, b"\x00" * 64))
    items.append((pk[:31], msg, sig))
    items.append((pk, msg, sig[:63]))
    return items


def test_eager_ref_verify_matches_libsodium(no_libsodium):
    from stellar_tpu.xdr.xtypes import PublicKey as JPublicKey
    from stellar_tpu_torch.xdr.xtypes import PublicKey

    items = _lanes()
    want = [jsodium.verify_detached(s, m, p) for p, m, s in items]
    assert any(want) and not all(want)
    keys.verify_cache().clear()
    got = [PubKeyUtils.verify_sig_uncached(p, s, m) for p, m, s in items]
    assert got == want
    n = len(items)
    assert keys.stats() == {"eager_ref_verifies": n}
    # the cached eager verify: the JAX package's verdicts (libsodium), and
    # valid verdicts latched — the second pass over valid lanes runs nothing
    full = [(p, m, s) for p, m, s in items if len(p) == 32]
    jgot = [JPubKeyUtils.verify_sig(JPublicKey.from_ed25519(p), s, m) for p, m, s in full]
    assert [PubKeyUtils.verify_sig(PublicKey.from_ed25519(p), s, m) for p, m, s in full] == jgot
    assert keys.stats()["eager_ref_verifies"] == n + len(full)
    valid = [(p, m, s) for (p, m, s), ok in zip(full, jgot) if ok]
    assert all(PubKeyUtils.verify_sig(PublicKey.from_ed25519(p), s, m) for p, m, s in valid)
    assert keys.stats()["eager_ref_verifies"] == n + len(full)
    keys.verify_cache().clear()
    JPubKeyUtils.clear_verify_sig_cache()


def test_secret_key_without_libsodium_signs_libsodiums_bytes(no_libsodium):
    for seed_hex, msg in RFC8032:
        seed = H(seed_hex)
        pk, sk = jsodium.sign_seed_keypair(seed)
        key = SecretKey.from_seed(seed)
        assert key.public_raw == pk
        assert key.sign(msg) == jsodium.sign_detached(msg, sk)
        assert key.get_strkey_seed() == SecretKey.from_strkey_seed(key.get_strkey_seed()).get_strkey_seed()
    key = SecretKey.random()
    assert PubKeyUtils.verify_sig(key.get_public_key(), key.sign(b"x"), b"x")
    keys.verify_cache().clear()
