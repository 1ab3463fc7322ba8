"""The port's device mesh (``parallel/mesh.py``) and the sharded verify path
it drives, against the JAX package's on this CPU host.

The twins of ``tests/test_sig_mesh.py`` (the SIG_MESH knob,
``mesh_from_spec``, the backend wiring, quarantine and the wedge latch
under a mesh, an Application booted with ``SIG_MESH = "auto"``),
``tests/test_ed25519_tpu.py::TestShardedVerifier`` and
``tests/test_sha512_device.py::TestDeviceHashSharded``.

Where the JAX tests stand up a host with several devices
(``jax.local_devices`` over the conftest's eight virtual CPU devices), these
replace ``parallel.mesh.local_devices`` with a list that names the CPU
device several times: a mesh that repeats a device is the rig that drives
every part of the sharded path — per-shard staging, the tail shard, dead
shards, the gather — but the copy to a second card.  The port runs each
shard through the verify kernel's plain PyTorch version (about a second a
call here), so the sets keep to two or three shards, except the one
eight-shard set held against the JAX package's eight-device verifier.
JAX is imported inside fixtures only: the ``cuda`` cases run on a card's
machine, which has no JAX.  Tolerance: exact — every verdict, count and
header hash equal.
"""

from __future__ import annotations

import importlib
import random
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from stellar_tpu_torch.crypto import SecretKey, make_backend, sodium  # noqa: E402
from stellar_tpu_torch.crypto.sigbackend import (  # noqa: E402
    CALLER_CLOSE,
    CALLER_PIPELINE,
    CachingSigBackend,
    DeviceStallError,
    GpuSigBackend,
)
from stellar_tpu_torch.crypto.sigcache import VerifySigCache  # noqa: E402
from stellar_tpu_torch.main.config import Config  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from stellar_tpu_torch.ops import ref25519 as ref  # noqa: E402
from stellar_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from stellar_tpu_torch.parallel.mesh import (  # noqa: E402
    DeviceMesh,
    make_mesh,
    make_sharded_verifier,
    mesh_from_spec,
)
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

CPU = torch.device("cpu")
GOOD = (0, False, "auto", 1, 8)
BAD = (True, -1, "8", "all", 1.5, [8])


def _cpus(n):
    return [CPU] * n


@pytest.fixture
def cpu_host(monkeypatch):
    """``local_devices`` of a host with ``n`` devices (the CPU device named
    n times), for whichever kind is asked; returns the setter."""

    def with_devices(n):
        seen = []

        def fake(kind="cuda"):
            seen.append(kind)
            return _cpus(n)

        monkeypatch.setattr(tmesh, "local_devices", fake)
        return seen

    return with_devices


def _signed(n, seed, tag=b"mesh", bad_every=3):
    rng = random.Random(seed)
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(seed + i)
        msg = tag + bytes(rng.randrange(256) for _ in range(rng.choice((0, 16, 40, 47, 48, 90))))
        sig = bytearray(sk.sign(msg))
        if bad_every and i % bad_every == 0:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        items.append((sk.public_raw, msg, bytes(sig)))
    return items


def _hostile(seed=92000):
    """The hostile lanes of tests/test_sha512_device.py::_hostile_items."""
    sk = SecretKey.pseudo_random_for_testing(seed)
    msg = b"hostile lane"
    pk, sig = sk.public_raw, sk.sign(msg)
    bad_r = bytearray(sig)
    bad_r[3] ^= 0x10
    return [
        (pk, msg, sig[:32] + ref.L.to_bytes(32, "little")),
        (pk, msg, sig[:32] + (ref.L + 7).to_bytes(32, "little")),
        (pk, msg, sig[:32] + (2**256 - 1).to_bytes(32, "little")),
        (pk, b"different message", sig),
        (pk, msg, bytes(bad_r)),
        (bytes(32), msg, sig),
        (pk[:31], msg, sig),
        (pk, msg, sig[:63]),
        (pk, msg, sig),
    ]


def _gate_rejected():
    """The hostile lanes the strict input gate refuses (s >= L, a
    small-order A, short fields)."""
    return [_hostile()[j] for j in (0, 1, 2, 5, 6, 7)]


def _mixed_43():
    """43 lanes: signed lanes (every third corrupted) with the hostile
    lanes spread among them."""
    items = _signed(34, 95000)
    for j, h in enumerate(_hostile()):
        items.insert(4 * j + 1, h)
    assert len(items) == 43
    return items


def _want(items):
    return [sodium.verify_detached(s, m, p) for p, m, s in items]


def _launch_lanes(bv):
    """Record the lanes of each kernel call of ``bv`` (one a launched
    shard); returns the list it fills."""
    lanes = []
    real = bv._verify_packed

    def counted(p):
        lanes.append(int(p.shape[1]))
        return real(p)

    bv._verify_packed = counted
    return lanes


# -- 1. the knob ---------------------------------------------------------------


class TestConfigKnob:
    def test_default_off_and_valid_values(self):
        cfg = Config()
        assert cfg.SIG_MESH == 0
        cfg.validate()
        for good in GOOD:
            cfg.SIG_MESH = good
            cfg.validate()

    @pytest.mark.parametrize("bad", BAD, ids=repr)
    def test_rejects_malformed(self, bad):
        cfg = Config()
        cfg.SIG_MESH = bad
        with pytest.raises(ValueError, match="SIG_MESH"):
            cfg.validate()

    def test_from_dict_plumbs(self):
        assert Config.from_dict({"SIG_MESH": "auto"}).SIG_MESH == "auto"

    def test_knob_table_matches_jax(self):
        """The JAX package's Config accepts and refuses the same values."""
        from stellar_tpu.main.config import Config as JaxConfig

        for value in GOOD + BAD:
            verdicts = []
            for cls in (Config, JaxConfig):
                cfg = cls()
                cfg.SIG_MESH = value
                try:
                    cfg.validate()
                    verdicts.append(True)
                except ValueError:
                    verdicts.append(False)
            assert verdicts[0] == verdicts[1] == (value in GOOD and value is not True), value


# -- 2. mesh_from_spec -----------------------------------------------------------


class TestMeshFromSpec:
    def test_off(self):
        assert mesh_from_spec(0) is None
        assert mesh_from_spec(None) is None
        assert mesh_from_spec(False) is None

    def test_auto_takes_every_local_device(self, cpu_host):
        seen = cpu_host(8)
        mesh = mesh_from_spec("auto")
        assert isinstance(mesh, DeviceMesh) and len(mesh) == 8
        assert mesh.devices == tuple(_cpus(8)) and seen == ["cuda"]

    def test_auto_single_device_stays_unsharded(self):
        # the CPU has one device: the unsharded path IS that configuration
        assert tmesh.local_devices("cpu") == [CPU]
        assert mesh_from_spec("auto", device="cpu") is None
        with pytest.raises(ValueError, match="addressable"):
            mesh_from_spec(2, device="cpu")

    def test_explicit_count(self, cpu_host):
        cpu_host(8)
        mesh = mesh_from_spec(3)
        assert len(mesh) == 3 and mesh.axis_names == ("batch",)

    def test_explicit_one_normalizes_to_unsharded(self, cpu_host):
        cpu_host(8)
        assert mesh_from_spec(1) is None

    def test_explicit_count_too_large_raises(self, cpu_host):
        cpu_host(8)
        with pytest.raises(ValueError, match="addressable"):
            mesh_from_spec(9)

    def test_make_mesh_defaults_to_local_devices(self, cpu_host):
        seen = cpu_host(2)
        mesh = make_mesh()
        assert seen and len(mesh) == 2

    def test_mesh_is_a_frozen_tuple_of_one_type(self):
        mesh = make_mesh(["cpu", CPU])
        assert mesh.devices == (CPU, CPU) and len(mesh) == 2
        with pytest.raises(AttributeError):
            mesh.devices = ()
        with pytest.raises(ValueError, match="axis"):
            make_mesh(["cpu"], axis="model")
        with pytest.raises(ValueError):
            make_mesh([])

    def test_cuda_devices_raise_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.local_devices("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_from_spec("auto")
        with pytest.raises(ValueError):
            tmesh.local_devices("tpu")


# -- 3. the backend wiring --------------------------------------------------------


class TestBackendWiring:
    def test_sig_mesh_builds_the_verifier_mesh(self, cpu_host):
        cpu_host(8)
        be = GpuSigBackend(max_batch=16, sig_mesh=8, device="cpu")
        assert be._verifier.mesh is not None and len(be._verifier.mesh) == 8
        assert be.stats()["mesh_devices"] == 8

    def test_sig_mesh_off_stays_unsharded(self):
        be = GpuSigBackend(max_batch=16, device="cpu")
        assert be._verifier.mesh is None
        assert be.stats()["mesh_devices"] == 0

    def test_explicit_mesh_wins_over_spec(self, cpu_host):
        cpu_host(8)
        mesh = make_mesh(_cpus(2))
        be = GpuSigBackend(max_batch=16, mesh=mesh, sig_mesh=8)
        assert be._verifier.mesh is mesh
        assert be.stats()["mesh_devices"] == 2
        with pytest.raises(ValueError, match="type"):
            GpuSigBackend(max_batch=16, mesh=mesh, device="cuda")

    def test_make_backend_passthrough(self, cpu_host):
        cpu_host(8)
        be = make_backend("gpu", cache=VerifySigCache(), max_batch=16, sig_mesh=4, device="cpu")
        assert be.stats()["mesh_devices"] == 4

    def test_bucket_splits_evenly_over_any_mesh_width(self):
        """Every bucket is a whole multiple of the shard count, and equals
        the JAX package's verifier's bucket on the same mesh width."""
        import jax
        from stellar_tpu.ops.ed25519 import BatchVerifier as JaxVerifier
        from stellar_tpu.parallel.mesh import make_mesh as jax_mesh

        for width in (2, 3, 5, 8):
            bv = ted.BatchVerifier(max_batch=100, mesh=make_mesh(_cpus(width)))
            jbv = JaxVerifier(max_batch=100, mesh=jax_mesh(jax.devices()[:width]), backend="xla")
            assert bv.max_batch % width == 0 and bv.max_batch == jbv.max_batch
            for n in (1, width - 1, width + 1, 50, 100, 1000):
                assert bv._bucket(n) % width == 0
                assert bv._bucket(n) == jbv._bucket(n), (width, n)


# -- 4. the sharded verifier --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded verifier on the conftest's eight virtual
    CPU devices at its bucket-64 shape (the shape test_sig_mesh.py and
    TestShardedVerifier compile)."""
    import jax
    from stellar_tpu.parallel.mesh import make_mesh as jax_mesh
    from stellar_tpu.parallel.mesh import make_sharded_verifier as jax_sharded_verifier

    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    return jax_sharded_verifier(mesh=jax_mesh(devs[:8]), max_batch=64, min_device_batch=64,
                                backend="xla")


class TestShardedVerifier:
    def test_43_lanes_over_8_shards_match_jax_and_libsodium(self, jax_sharded):
        items = _mixed_43()
        want = _want(items)
        assert any(want) and not all(want)
        bv = make_sharded_verifier(mesh=make_mesh(_cpus(8)), max_batch=64)
        lanes = _launch_lanes(bv)
        got = bv.verify(items)
        assert got == want
        assert jax_sharded.verify(items) == want
        assert bv.n_device_calls == jax_sharded.n_device_calls == 1
        # the JAX layout: lanes shard-major over bucket // 8, the tail shard
        # padded, the shards past the live range dead
        width = jax_sharded._bucket(43) // 8
        layout = [min(width, max(0, 43 - k * width)) for k in range(8)]
        assert layout == [8, 8, 8, 8, 8, 3, 0, 0]
        assert [cnt for _, _, cnt in bv._shard_ranges(43)] == [c for c in layout if c]
        assert lanes == [c for c in layout if c]  # one launch a live shard, none for dead
        st = bv.stats()
        assert st["mesh_devices"] == 8
        assert st["gate_rejects"] == jax_sharded.stats()["gate_rejects"] == 6

    def test_device_hash_remainder_with_a_dead_shard(self):
        items = _mixed_43()
        bv = ted.BatchVerifier(max_batch=64, mesh=make_mesh(_cpus(3)),
                               device_hash=True)
        lanes = _launch_lanes(bv)  # the device-hash path runs its own plain pair
        assert bv.max_batch == 66 and bv._bucket(43) == 66
        assert bv._shard_ranges(43) == [(0, 0, 22), (1, 22, 21)]  # shard 2 dead
        from stellar_tpu_torch.ops import sha512

        calls = ted.plain_calls
        h_calls = sha512.plain_calls
        assert bv.verify(items) == _want(items)
        assert lanes == []  # device hash: the (160, n) pair, not the 128-row call
        assert ted.plain_calls - calls == 2 and sha512.plain_calls - h_calls == 2
        st = bv.stats()
        assert st["mesh_devices"] == 3 and st["device_hash"] is True

    def test_every_shard_gate_rejected_launches_nothing(self):
        bv = ted.BatchVerifier(max_batch=64, mesh=make_mesh(_cpus(2)))
        lanes = _launch_lanes(bv)
        hostile = _gate_rejected() * 4
        assert bv.verify(hostile) == [False] * len(hostile)
        assert lanes == [] and bv.n_device_calls == 0
        # one shard of gate rejects beside a live one: only the live one launches
        items = (_gate_rejected() * 3)[:16] + _signed(16, 96000, bad_every=0)
        assert bv.verify(items) == [False] * 16 + [True] * 16
        assert lanes == [16] and bv.n_device_calls == 1

    def test_chunks_beyond_max_batch_each_shard(self):
        items = _signed(12, 97000)
        bv = ted.BatchVerifier(max_batch=7, mesh=make_mesh(_cpus(2)))
        lanes = _launch_lanes(bv)
        assert bv.max_batch == 8
        assert bv.verify(items) == _want(items)
        # chunks of 8 and 4 lanes (through the stager pipeline): 4 + 4, then
        # 4 lanes of a bucket capped at max_batch, its second shard dead
        assert lanes == [4, 4, 4] and bv.n_device_calls == 2


class TestTorsionSharded:
    @staticmethod
    def _encs():
        B = ref.base_point()
        encs = [ref.compress(ref.scalar_mult(k, B)) for k in range(1, 20)]
        encs += [bytes(e) for e in ref.small_order_blacklist()][:3]
        t8, y = None, 2
        while t8 is None:  # a point of order 8
            q = ref.decompress(y.to_bytes(32, "little"))
            y += 1
            if q is not None:
                t = ref.scalar_mult(ref.L, q)
                if not ref.point_equal(ref.scalar_mult(4, t), ref.IDENT):
                    t8 = t
        encs += [ref.compress(ref.point_add(ref.scalar_mult(5, B), t8)),
                 (ref.P + 1).to_bytes(32, "little"), b"\x01" * 31]
        exp = []
        for e in encs:
            pt = ref.decompress(e) if len(e) == 32 and ref.fe_is_canonical(e) else None
            exp.append(pt is not None and ref.is_torsion_free(pt))
        return encs, exp

    @pytest.mark.parametrize("device_hash", [False, True])
    def test_torsion_remainder(self, device_hash):
        encs, exp = self._encs()
        bv = ted.BatchVerifier(max_batch=64, mesh=make_mesh(_cpus(3)), device_hash=device_hash)
        lanes = _launch_lanes(bv)
        assert bv._shard_ranges(len(encs)) == [(0, 0, 12), (1, 12, 12), (2, 24, 1)]
        assert bv.verify_torsion(encs) == exp
        # torsion chunks are 128-row chunks either way; the tail shard's one
        # lane is the short encoding, refused on the host: no launch there
        assert lanes == [12, 12]
        assert bv.stats()["torsion_items"] == len(encs)


# -- 5. the flush contracts under a mesh -----------------------------------------


@pytest.fixture(scope="module")
def mesh_backend():
    """One shared two-shard GpuSigBackend (the plain versions on the CPU)
    for the contract tests, warmed by one call."""
    be = GpuSigBackend(max_batch=64, mesh=make_mesh(_cpus(2)), cpu_cutover=0)
    assert all(be.verify_batch(_signed(40, 4900, bad_every=0)))
    assert be._verifier.n_device_calls >= 1
    return be


class TestQuarantineUnderMesh:
    def test_inflight_sharded_prewarm_quarantine_keeps_cache_clean(self, mesh_backend):
        cache = VerifySigCache()
        be = CachingSigBackend(mesh_backend, cache)
        items = _signed(40, 4000, bad_every=0)
        real = mesh_backend._verifier.verify
        done_compute = threading.Event()
        release = threading.Event()

        def gated_verify(batch):
            out = real(batch)  # the sharded round trip itself
            done_compute.set()
            assert release.wait(60), "test gate never released"
            return out

        mesh_backend._verifier.verify = gated_verify
        try:
            fut = be.verify_batch_async(items, caller=CALLER_PIPELINE)
            assert done_compute.wait(120), "the sharded dispatch never ran"
            fut.quarantine()  # while the future is still pending
            release.set()
            assert fut._done.wait(60)
        finally:
            mesh_backend._verifier.verify = real
        with pytest.raises(RuntimeError, match="quarantined"):
            fut.result(timeout=5)
        assert len(cache) == 0, "a quarantined flush left cache entries"

    def test_completed_sharded_flush_quarantine_evicts(self, mesh_backend):
        cache = VerifySigCache()
        be = CachingSigBackend(mesh_backend, cache)
        items = _signed(40, 4200, bad_every=0)
        fut = be.verify_batch_async(items, caller=CALLER_PIPELINE)
        assert fut.result(timeout=120) == [True] * len(items)
        assert len(cache) == len(items)
        fut.quarantine()
        assert len(cache) == 0


class TestWedgeLatchUnderMesh:
    def test_per_caller_latch_scopes_survive_mesh_dispatch(self, mesh_backend):
        """A sharded pipeline dispatch the card never answers raises and
        latches ONLY the pipeline caller class; the close path keeps
        dispatching over the mesh (the port's stall contract: no batch
        moves to the host)."""
        be = mesh_backend
        items = _signed(40, 4400)
        want = _want(items)
        real = be._verifier.verify
        release, running = threading.Event(), []
        saved = (be.DEVICE_TIMEOUT, be.DEVICE_GIVE_UP)
        be.DEVICE_TIMEOUT, be.DEVICE_GIVE_UP = 0.2, 0.4

        def wedged(batch):
            running.append(1)
            try:
                release.wait(60)
                return real(batch)
            finally:
                running.pop()

        be._verifier.verify = wedged
        try:
            with pytest.raises(DeviceStallError, match="stalled"):
                be.verify_batch(items, caller=CALLER_PIPELINE)
            with pytest.raises(DeviceStallError, match="latched"):
                be.verify_batch(items, caller=CALLER_PIPELINE)
            assert be.n_latch_flips.get(CALLER_PIPELINE) == 1
            assert CALLER_CLOSE not in be.n_latch_flips
        finally:
            release.set()
            be._verifier.verify = real
            be.DEVICE_TIMEOUT, be.DEVICE_GIVE_UP = saved
        end = time.monotonic() + 60
        while running and time.monotonic() < end:
            time.sleep(0.05)
        assert not running, "the wedged worker never ran out"
        with be._wedge_lock:
            assert list(be._wedged_until) == [CALLER_PIPELINE]
        calls_before = be._verifier.n_device_calls
        assert be.verify_batch(items, caller=CALLER_CLOSE) == want
        assert be._verifier.n_device_calls == calls_before + 1
        st = be.stats()
        assert st["wedge_latch_flips"] == {CALLER_PIPELINE: 1} and st["mesh_devices"] == 2
        with be._wedge_lock:  # leave the shared fixture unlatched
            be._wedged_until.clear()


# -- 6. a node booted with SIG_MESH = "auto" ----------------------------------------


N_PAY = 12


def _standalone_hashes(pkg, tmp, backend, **knobs):
    """A standalone node: accounts created, then two rounds of N_PAY
    payments, the second with one flipped signature byte; returns the
    header hashes, the txset verdicts and the node's backend stats."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    T, clock, X = m("tx.testutils"), m("util.clock"), m("xdr.ledger")
    keys = m("crypto.keys")
    keys.PubKeyUtils.clear_verify_sig_cache()
    cfg = T.get_test_config(0, backend=backend)
    cfg.BUCKET_DIR_PATH, cfg.TMP_DIR_PATH = str(tmp / "buckets"), str(tmp / "tmp")
    cfg.DESIRED_MAX_TX_PER_LEDGER = 4 * N_PAY
    for k, v in knobs.items():
        setattr(cfg, k, v)
    app = m("main.application").Application.create(
        clock.VirtualClock(clock.VIRTUAL_TIME), cfg, new_db=True)
    try:
        lm = app.ledger_manager
        root = T.root_key_for(app)
        accounts = [T.get_account(i + 1) for i in range(N_PAY + 1)]
        hashes, verdicts = [], []

        def close(txs, upgrades=()):
            ts = m("herder.txset").TxSetFrame(lm.last_closed.hash, txs)
            ts.sort_for_hash()
            verdicts.append(ts.check_valid(app))
            sv = X.StellarValue(ts.get_contents_hash(),
                                lm.last_closed.header.scpValue.closeTime + 5, list(upgrades), 0)
            lm.close_ledger(m("herder.ledgerclose").LedgerCloseData(
                lm.current.header.ledgerSeq, ts, sv))
            hashes.append(lm.last_closed.hash.hex())

        up = m("xdr.base").xdr_to_opaque(
            X.LedgerUpgrade(X.LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE, 4 * N_PAY))
        close([T.tx_from_ops(app, root, 1, [T.create_account_op(a, 10**10) for a in accounts])],
              [up])
        created = lm.last_closed.header.ledgerSeq
        for r in range(2):
            txs = []
            for i in range(N_PAY):
                tx = T.tx_from_ops(app, accounts[i], (created << 32) + 1 + r,
                                   [T.payment_op(accounts[i + 1], 1000)])
                if r == 1 and i == 5:
                    ds = tx.envelope.signatures[0]
                    ds.signature = bytes([ds.signature[0] ^ 1]) + ds.signature[1:]
                    tx.clear_cached()
                txs.append(tx)
            close(txs)
        return hashes, verdicts, app.sig_backend.stats()
    finally:
        app.graceful_stop()
        keys.PubKeyUtils.clear_verify_sig_cache()


def test_auto_mesh_application_closes_match_jax(cpu_host, tmp_path):
    """A validator config turns on sharded dispatch without code:
    SIG_MESH = "auto" on a host with two devices boots a node whose verify
    backend is two shards wide, and its closes equal the JAX package's
    hash for hash (the JAX node's directories under tmp_path)."""
    from stellar_tpu_torch.ops import ed25519

    cpu_host(2)
    calls = ed25519.plain_calls
    got = _standalone_hashes("stellar_tpu_torch", tmp_path / "port", "gpu",
                             SIG_DEVICE="cpu", SIG_MESH="auto")
    want = _standalone_hashes("stellar_tpu", tmp_path / "jax", "cpu")
    assert got[2]["mesh_devices"] == 2 and got[2]["device_calls"] >= 2
    assert ed25519.plain_calls > calls
    assert got[:2] == want[:2]
    assert got[1] == [True, True, False]


# -- 7. on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("device_hash", [False, True])
def test_repeated_device_mesh_on_card_matches_unsharded(device_hash):
    """[cuda:0] * 3: per-shard staging, streams and launches on one card;
    verdicts equal the unsharded verifier's and those known by
    construction; one B1 launch a live shard."""
    _need_card()
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    items = _signed(300, 98000)
    want = [i % 3 != 0 for i in range(300)]
    one = ted.BatchVerifier(max_batch=256, device="cuda", device_hash=device_hash)
    bv = make_sharded_verifier(mesh=make_mesh([torch.device("cuda", 0)] * 3), max_batch=256,
                               device_hash=device_hash)
    assert one.verify(items) == want
    before = ec.launches
    assert bv.verify(items) == want
    # chunks of 258 and 42 lanes: 86+86+86, then 24+18 of a bucket of 72
    assert ec.launches - before == 5 and bv.n_device_calls == 2
    assert bv.verify_torsion([p for p, _, _ in items[:50]]) == [True] * 50


@pytest.mark.cuda
def test_two_card_mesh_launches_on_each_card():
    """A shard on cuda:1 launches there while cuda:0 is current, B2 too
    under device hashing, and the torsion proofs; ``launch_device``
    switches only to a card that is not current, and switches back."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import launch_device
    from stellar_tpu_torch.ops import sha512_cuda as sc

    items = _signed(64, 99000)
    with torch.cuda.device(0):
        with launch_device(torch.device("cuda", 1)):
            assert torch.cuda.current_device() == 1
        assert torch.cuda.current_device() == 0
        for device_hash in (False, True):
            bv = make_sharded_verifier(mesh=make_mesh(["cuda:0", "cuda:1"]), max_batch=64,
                                       device_hash=device_hash)
            b1, b2 = ec.launches, sc.launches
            assert bv.verify(items) == [i % 3 != 0 for i in range(64)]
            assert ec.launches - b1 == 2 and sc.launches - b2 == (2 if device_hash else 0)
            assert bv.verify_torsion([p for p, _, _ in items[:40]]) == [True] * 40
            assert torch.cuda.current_device() == 0
