"""The port's verify plane as a whole (stellar_tpu_torch BatchVerifier,
GpuSigBackend, make_backend, the C host stage) against the JAX package's
BatchVerifier(backend="xla") and libsodium, on this CPU host.

The port runs with ``device="cpu"``, i.e. its plain PyTorch kernel, over
exactly the live lanes of each chunk; the JAX side is kept to one compiled
shape (bucket 64).  Tolerance: exact —
every verdict equal, the staged bytes equal byte for byte.
"""

import random
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from stellar_tpu import native as jnative  # noqa: E402
from stellar_tpu.ops import ed25519 as jed  # noqa: E402
from stellar_tpu_torch import native as tnative  # noqa: E402
from stellar_tpu_torch.crypto import SecretKey, make_backend, sodium  # noqa: E402
from stellar_tpu_torch.crypto.sigbackend import DeviceStallError, GpuSigBackend  # noqa: E402
from stellar_tpu_torch.crypto.sigcache import VerifySigCache  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from stellar_tpu_torch.ops import ed25519_cuda  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as ref  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)


@pytest.fixture(scope="module")
def port():
    return ted.BatchVerifier(device="cpu", max_batch=64)


@pytest.fixture(scope="module")
def jbv():
    return jed.BatchVerifier(max_batch=64, min_device_batch=64, backend="xla")


def _sodium(items):
    return [sodium.verify_detached(s, m, p) for p, m, s in items]


def _three_way(port, jbv, items):
    want = _sodium(items)
    assert port.verify(items) == want
    assert jbv.verify(items) == want
    return want


def _signed(n, tag, rng, bad_every=2, max_len=100):
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(i)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, max_len)))
        sig = bytearray(sk.sign(tag + msg))
        if bad_every and i % bad_every:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        items.append((sk.public_raw, tag + msg, bytes(sig)))
    return items


def test_rfc8032_vectors(port, jbv):
    cases = [
        ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60", b""),
        ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb", b"\x72"),
        ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7", b"\xaf\x82"),
    ]
    items = []
    for seed_hex, msg in cases:
        sk = SecretKey.from_seed(bytes.fromhex(seed_hex))
        items.append((sk.public_raw, msg, sk.sign(msg)))
    assert _three_way(port, jbv, items) == [True, True, True]
    # RFC 8032 §7.1 TEST 1 public key and signature bytes
    assert items[0][0].hex() == (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
    )


def test_random_mutations(port, jbv):
    items = _signed(48, b"mut", random.Random(1234))
    want = _three_way(port, jbv, items)
    assert any(want) and not all(want)


def test_adversarial_inputs(port, jbv):
    sk = SecretKey.pseudo_random_for_testing(0)
    msg = b"m"
    sig = sk.sign(msg)
    adv = []
    for e in ref.small_order_blacklist():
        adv.append((e, msg, sig))  # small-order pk
        adv.append((sk.public_raw, msg, e + sig[32:]))  # small-order R
    bad_s = (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    adv.append((sk.public_raw, msg, sig[:32] + bad_s))  # s >= L
    adv.append(((2**255 - 5).to_bytes(32, "little"), msg, sig))  # y >= p
    adv.append((sk.public_raw, msg, b"\x00" * 64))  # zero sig
    adv.append((sk.public_raw[:31], msg, sig))  # short key
    adv.append((sk.public_raw, msg, sig[:63]))  # short sig
    calls = port.n_device_calls
    assert not any(_three_way(port, jbv, adv))
    assert port.n_device_calls == calls  # every lane gate-rejected: no launch


def test_three_chunk_batch_with_partial_tail(port, jbv):
    items = _signed(150, b"chunks", random.Random(7), bad_every=3, max_len=300)
    calls = port.n_device_calls
    want = _three_way(port, jbv, items)
    assert port.n_device_calls == calls + 3  # 64 + 64 + 22 lanes
    assert sum(want) == 50


def test_empty_and_gate_only_batches(port):
    assert port.verify([]) == []
    calls = port.n_device_calls
    bad = [(b"\x00" * 32, b"m", b"\x00" * 64)] * 3
    assert port.verify(bad) == [False, False, False]
    assert port.n_device_calls == calls
    assert port.stats()["gate_rejects"] >= 3


def test_host_assist_matches_and_reraises():
    items = _signed(40, b"assist", random.Random(77), bad_every=3)
    ha = ted.BatchVerifier(device="cpu", max_batch=64, host_assist=0.4)
    assert ha.verify(items) == _sodium(items)
    assert ha.n_host_assist_items == 16  # 0.4 * 40 peeled to host
    # a failing assist thread re-raises on the caller after the join
    bad = list(items)
    bad[-1] = (items[-1][0], items[-1][1], None)  # in the host-assist tail
    with pytest.raises(Exception):
        ha.verify(bad)


def _torsion_lanes():
    """Mixed-torsion lanes: prime-order points, prime-order plus 8-torsion,
    small-order encodings, random bytes, a non-canonical and a short
    encoding; with their ref25519 verdicts."""
    rng = random.Random(31)
    pts = [ref.decompress(SecretKey.pseudo_random_for_testing(i).public_raw) for i in range(4)]
    t8, y = None, 2
    while t8 is None:  # a point of order 8: [L]·Q of a Q with full torsion
        q = ref.decompress(y.to_bytes(32, "little"))
        y += 1
        if q is not None:
            t = ref.scalar_mult(ref.L, q)
            if not ref.point_equal(ref.scalar_mult(4, t), ref.IDENT):
                t8 = t
    encs = [ref.compress(p) for p in pts]
    encs += [ref.compress(ref.point_add(p, t8)) for p in pts[:2]]  # mixed torsion
    encs += list(ref.small_order_blacklist()[:3])
    encs += [rng.getrandbits(255).to_bytes(32, "little") for _ in range(3)]
    encs += [(ref.P + 1).to_bytes(32, "little"), b"\x01" * 31]  # non-canonical, short
    want = []
    for e in encs:
        pt = ref.decompress(e) if len(e) == 32 and ref.fe_is_canonical(e) else None
        want.append(pt is not None and ref.is_torsion_free(pt))
    assert any(want) and not all(want)
    return encs, want


def test_verify_torsion_matches_oracle(port):
    encs, want = _torsion_lanes()
    assert port.verify_torsion(encs) == want
    assert port.verify_torsion([]) == []


def test_sighash_stage_byte_exact():
    """The port's copy of the C host stage fills the packed buffer and the
    ok vector exactly like the JAX package's, single- and multi-block
    messages, gate rejects, malformed lengths and bucket padding."""
    rng = random.Random(5)
    items = _signed(40, b"", rng, bad_every=5, max_len=400)
    items += [(b"\x00" * 32, b"m", b"\x00" * 64), (b"\x01" * 31, b"x", b"\x02" * 64)]
    sk = SecretKey.pseudo_random_for_testing(1)
    s = sk.sign(b"big")
    items.append((sk.public_raw, b"big", s[:32] + (int.from_bytes(s[32:], "little") + ref.L).to_bytes(32, "little")))
    items.append((sk.public_raw, bytes(range(256)) * 9, sk.sign(bytes(range(256)) * 9)))
    n, stride = len(items), 64
    outs = []
    for mod in (tnative.load_sighash(), jnative.load_sighash()):
        packed = np.full((128, stride), 0xAB, dtype=np.uint8)
        ok = np.full(stride, 7, dtype=np.uint8)
        rejects = mod.stage(items, 0, n, packed, ok, ted._BLACKLIST, 0)
        outs.append((packed, ok[:n].copy(), rejects))
    (tp, tok, trej), (jp, jok, jrej) = outs
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tok, jok)
    assert trej == jrej > 0
    # the stage writes straight into a torch tensor through .numpy()
    buf = torch.empty(128 * n, dtype=torch.uint8).view(128, n)
    okb = np.empty(n, dtype=np.uint8)
    tnative.load_sighash().stage(items, 0, n, buf.numpy(), okb, ted._BLACKLIST, 0)
    np.testing.assert_array_equal(buf.numpy(), jp[:, :n])
    np.testing.assert_array_equal(okb, jok)


def test_make_backend_gpu_on_cpu_with_cache():
    cache = VerifySigCache()
    backend = make_backend("gpu", cache=cache, device="cpu", cpu_cutover=0)
    inner = backend.inner
    assert isinstance(inner, GpuSigBackend) and backend.name == "gpu"
    inner.DEVICE_TIMEOUT = inner.DEVICE_FIRST_TIMEOUT = 600.0  # CPU plain runs
    items = _signed(20, b"backend", random.Random(3), bad_every=4)
    want = _sodium(items)
    assert backend.verify_batch(items, caller="close") == want
    calls = inner.stats()["device_calls"]
    # second call: every valid verdict is a cache hit; invalid ones (never
    # latched) go back to the device
    fut = backend.verify_batch_async([it for it, ok in zip(items, want) if ok], caller="pipeline")
    assert fut.result(timeout=600) == [True] * sum(want)
    assert inner.stats()["device_calls"] == calls
    assert backend.verify_batch(items, caller="ingest") == want
    st = backend.stats()
    assert st["backend"] == "gpu" and st["device_calls"] == calls + 1
    assert st["cpu_cutover_items"] == st["stalled_items"] == st["stall_rejected_items"] == 0
    assert st["wedge_latch_flips"] == {}
    assert st["device_dispatches"] == {"close": 1, "ingest": 1}
    assert st["device_hash"] is False and st["mesh_devices"] == 0
    # the wrapper took the plain version: the tensors lay on the CPU
    assert ed25519_cuda.launches == 0


def test_backend_cutover_and_torsion_host_path():
    """Below the cutover the gpu backend verifies with libsodium and proves
    torsion on the host ladder (native/halfagg.c), as the JAX package's
    host path does; the cpu backend proves on the same host path."""
    from stellar_tpu.crypto import sigbackend as jsb

    backend = make_backend("gpu", cache=VerifySigCache(), device="cpu", cpu_cutover=1024)
    items = _signed(6, b"cut", random.Random(4), bad_every=3)
    assert backend.verify_batch(items) == _sodium(items)
    st = backend.stats()
    assert st["cpu_cutover_items"] == 6 and st["device_calls"] == 0
    encs, want = _torsion_lanes()
    jax_host = jsb.CpuSigBackend().torsion_check(encs)
    assert jax_host == want
    assert backend.torsion_check(encs) == want
    assert backend.stats()["cpu_cutover_torsion"] == len(encs)
    assert backend.stats()["device_calls"] == 0
    cpu = make_backend("cpu", cache=VerifySigCache())
    assert cpu.torsion_check(encs) == want
    # the decoded points the aggregate plane passes in prove the same
    vals = [ref.decompress(e) if len(e) == 32 and ref.fe_is_canonical(e) else None
            for e in encs]
    live = [i for i, v in enumerate(vals) if v is not None]
    assert cpu.torsion_check([encs[i] for i in live], vals=[vals[i] for i in live]) == [
        want[i] for i in live
    ]
    assert cpu.verify_batch(items) == _sodium(items)
    with pytest.raises(ValueError):
        make_backend("tpu")


def test_smallest_torsion_input_matches_jax():
    """One encoding of the base point: True on every host path."""
    from stellar_tpu.crypto import sigbackend as jsb

    enc = ref.compress(ref.base_point())
    assert jsb.make_backend("cpu", cache=jsb.VerifySigCache()).torsion_check([enc]) == [True]
    assert make_backend("cpu", cache=VerifySigCache()).torsion_check([enc]) == [True]
    assert GpuSigBackend(cpu_cutover=2, device="cpu").torsion_check([enc]) == [True]


def test_default_cutover_sends_small_batches_to_the_device(monkeypatch):
    """The default gpu backend dispatches every batch, however small, so it
    runs where libsodium is absent (the card's machine)."""
    items = _signed(6, b"default", random.Random(8), bad_every=3)
    want = _sodium(items)

    def no_libsodium():
        raise RuntimeError("libsodium not found")

    monkeypatch.setattr(sodium, "_load", no_libsodium)
    backend = make_backend("gpu", cache=VerifySigCache(), device="cpu")
    backend.inner.DEVICE_FIRST_TIMEOUT = 600.0  # the plain version's first run
    assert backend.verify_batch(items, caller="overlay") == want
    st = backend.stats()
    assert st["cpu_cutover_items"] == 0 and st["device_calls"] == 1


def _wedged(inner, answer_after=None):
    """Make ``inner``'s verifier block until released, or, with
    ``answer_after``, sleep that long and then answer; returns (release,
    drained, entered): ``drained(t)`` waits until every blocked call has
    run out."""
    release, lock, running = threading.Event(), threading.Lock(), [0]
    real_verify, real_torsion, entered = inner._verifier.verify, inner._verifier.verify_torsion, []

    def blocking(real):
        def call(batch):
            with lock:
                entered.append(len(batch))
                running[0] += 1
            if answer_after is None:
                release.wait(60)
            else:
                time.sleep(answer_after)
            try:
                return real(batch)
            finally:
                with lock:
                    running[0] -= 1

        return call

    def drained(timeout):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with lock:
                if running[0] == 0:
                    return True
            time.sleep(0.05)
        return False

    inner._verifier.verify = blocking(real_verify)
    inner._verifier.verify_torsion = blocking(real_torsion)
    return release, drained, entered


def test_device_stall_raises_and_latches_only_its_caller(monkeypatch):
    """A dispatch that outlives its budget is counted as stalled and the
    caller waits for the card's verdicts; one the card never answers
    within DEVICE_GIVE_UP raises DeviceStallError.  Nothing is verified
    on the host.  The caller class of the unanswered batch then fails fast
    without a dispatch, while another class still reaches the device."""
    items = _signed(4, b"stall", random.Random(9), bad_every=2)
    want = _sodium(items)
    spans = []

    class Tracer:
        def span(self, name, **attrs):
            import contextlib

            spans.append((name, attrs.get("caller"), attrs.get("items")))
            return contextlib.nullcontext()

    slow = GpuSigBackend(device="cpu", cpu_cutover=0)
    slow._tracer = Tracer()  # the backend's own spans (the verifier keeps its tracer)
    slow.DEVICE_FIRST_TIMEOUT = 0.2
    _, drained, entered = _wedged(slow, answer_after=0.5)
    monkeypatch.setattr(
        sodium, "verify_detached", lambda *a: pytest.fail("host verify after a stall")
    )
    assert slow.verify_batch(items, caller="ingest") == want
    assert entered == [4] and spans == [("sig.device_stall", "ingest", 4)]
    st = slow.stats()
    assert st["stalled_items"] == 4 and st["stall_rejected_items"] == 0
    assert st["wedge_latch_flips"] == {} and st["device_dispatches"] == {"ingest": 1}

    inner = GpuSigBackend(device="cpu", cpu_cutover=0)
    inner.DEVICE_FIRST_TIMEOUT, inner.DEVICE_GIVE_UP = 0.2, 0.4
    release, drained, entered = _wedged(inner)
    with pytest.raises(DeviceStallError, match="stalled"):
        inner.verify_batch(items, caller="pipeline")
    with pytest.raises(DeviceStallError, match="latched"):
        inner.verify_batch(items, caller="pipeline")
    assert entered == [4]  # the latched call never dispatched
    release.set()
    inner.DEVICE_FIRST_TIMEOUT = 600.0
    assert drained(60)  # the orphaned worker ran out on the device path
    assert inner.verify_batch(items, caller="close") == want
    st = inner.stats()
    assert st["wedge_latch_flips"] == {"pipeline": 1}
    assert st["stall_rejected_items"] == 8 and st["stalled_items"] == 4
    assert st["cpu_cutover_items"] == 0 and st["device_calls"] >= 1


def test_stall_verdicts_match_jax():
    """The same stalled verify and torsion batches on the JAX package's
    TpuSigBackend (which finishes them on the host) and on the port's
    GpuSigBackend (which waits for the card): equal verdicts.  The port
    counts every stalled item and latches nothing."""
    from stellar_tpu.crypto import sigbackend as jsb

    items = _signed(4, b"stall-jax", random.Random(19), bad_every=2)
    encs, want_t = _torsion_lanes()
    j = jsb.TpuSigBackend.__new__(jsb.TpuSigBackend)
    j.cpu_cutover, j.n_cutover_items, j.n_cutover_torsion = 0, 0, 0
    j.n_wedge_fallback_items, j._verify_warm, j._torsion_warm = 0, False, False
    j._wedged_until, j.n_latch_flips = {}, {}
    j._wedge_lock = threading.Lock()

    class Blocked:
        n_device_calls = 0

        def __init__(self):
            self.release = threading.Event()

        def verify(self, batch):
            self.release.wait(60)
            raise RuntimeError("released")

        verify_torsion = verify

        def stats(self):
            return {}

    j._verifier = Blocked()
    j.DEVICE_FIRST_TIMEOUT = 0.2
    inner = GpuSigBackend(device="cpu", cpu_cutover=0)
    inner.DEVICE_FIRST_TIMEOUT = 0.2
    _, drained, entered = _wedged(inner, answer_after=0.4)
    try:
        for b in (j, inner):
            assert b.verify_batch(items, caller="overlay") == _sodium(items)
            assert b.torsion_check(encs, caller="ingest") == want_t
        assert j.stats()["wedge_fallback_items"] == 4 + len(encs)
        ps = inner.stats()
        assert entered == [4, len(encs)]
        assert ps["stalled_items"] == 4 + len(encs) and ps["wedge_latch_flips"] == {}
        assert ps["device_dispatches"] == {"overlay": 1, "ingest": 1}
    finally:
        j._verifier.release.set()
        assert drained(60)  # no worker left running into interpreter exit


def test_kernel_error_still_raises():
    """An exception of the device call reaches the caller, and nothing is
    counted as a stall."""
    inner = GpuSigBackend(device="cpu", cpu_cutover=0)

    def broken(batch):
        raise RuntimeError("kernel launch failed")

    inner._verifier.verify = broken
    inner._verifier.verify_torsion = broken
    items = _signed(2, b"err", random.Random(3), bad_every=0)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        inner.verify_batch(items, caller="close")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        inner.torsion_check([items[0][0]], caller="overlay")
    st = inner.stats()
    assert st["stalled_items"] == st["stall_rejected_items"] == 0
    assert st["wedge_latch_flips"] == {}


def test_stats_keys_match_jax(port, jbv):
    assert set(port.stats()) == set(jbv.stats())
    assert port.stats()["backend"] == "gpu"


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the entry points run on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ted.BatchVerifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("gpu", cache=VerifySigCache())
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuSigBackend(device="cuda")


def test_secret_key_matches_jax_and_without_libsodium(monkeypatch):
    """Fixtures match the JAX package's key for key; without libsodium (the
    card's machine) the port derives and signs with ref25519, same bytes."""
    from stellar_tpu.crypto import SecretKey as JaxSecretKey

    for i in (0, 7):
        sk, jsk = SecretKey.pseudo_random_for_testing(i), JaxSecretKey.pseudo_random_for_testing(i)
        assert sk.public_raw == jsk.public_raw and sk.get_seed() == jsk.get_seed()
        assert sk.sign(b"fixture") == jsk.sign(b"fixture")
    monkeypatch.setattr(sodium, "available", lambda: False)
    sk = SecretKey.pseudo_random_for_testing(7)
    assert sk.public_raw == jsk.public_raw
    assert sk.sign(b"fixture") == jsk.sign(b"fixture")
