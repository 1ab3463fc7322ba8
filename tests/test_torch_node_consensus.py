"""Three validators of the port reach consensus and close the JAX package's
ledgers, hash for hash, on this CPU host.

The quorum of CoreTests.cpp:46 (threshold 2 of 3) with all three running,
over the loopback overlay on one virtual clock, under a seeded
``LoadGenerator(seed=1337)`` load of a few accounts and payments, run until
every node has closed ledger 5.  The JAX side runs ``SIGNATURE_BACKEND =
"cpu"`` (libsodium); the port runs ``"gpu"`` on ``SIG_DEVICE = "cpu"``, so
every batch verify (txset checks, prewarms, SCP envelope flushes, ingest
batches) runs the verify kernel's plain PyTorch version.  A second port leg
hides libsodium, as on the GPU machine: keys sign with ref25519, peer auth
runs the pure-Python X25519, and an eager verify runs ref25519 — which may
happen only for a peer-auth certificate or an invalid signature (the batch
plane prewarms every valid one).  Both packages' verify caches are cleared
before each leg.  Tolerance: exact — the header hash of every ledger 2..5 on
every node equal to the JAX run's, and ``all_ledgers_agree()``.
"""

from __future__ import annotations

import importlib
import threading

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

LEDGERS = 5
ACCOUNTS, TXS, RATE = 5, 20, 10


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _clear_caches():
    for pkg in ("stellar_tpu", "stellar_tpu_torch"):
        _m(pkg, "crypto.keys").PubKeyUtils.clear_verify_sig_cache()


def _consensus(pkg, tmp, backend, **knobs):
    """Ledger hashes 2..LEDGERS per node, and the first node's backend stats."""
    _clear_caches()
    sim_m = _m(pkg, "simulation")
    SecretKey = _m(pkg, "crypto.keys").SecretKey
    T = _m(pkg, "tx.testutils")
    headers = _m(pkg, "ledger.headerframe").LedgerHeaderFrame
    keys = [SecretKey.pseudo_random_for_testing(i + 1) for i in range(3)]
    qset = _m(pkg, "xdr.scp").SCPQuorumSet(2, [k.get_public_key() for k in keys], [])
    sim = sim_m.Simulation(sim_m.OVER_LOOPBACK)
    for i, k in enumerate(keys):
        cfg = T.get_test_config(sim._next_instance, backend=backend)
        cfg.BUCKET_DIR_PATH = str(tmp / f"buckets{i}")
        cfg.TMP_DIR_PATH = str(tmp / f"tmp{i}")
        for name, v in knobs.items():
            setattr(cfg, name, v)
        sim.add_node(k, qset, cfg=cfg)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        sim.add_pending_connection(keys[a], keys[b])
    try:
        sim.start_all_nodes()
        app = sim.get_node(keys[0])
        lg = sim_m.LoadGenerator(seed=1337)
        lg.generate_load(app, ACCOUNTS, TXS, rate=RATE)
        ok = sim.crank_until(lambda: lg.is_done() and sim.have_all_externalized(LEDGERS), 900)
        assert ok, f"nodes stuck at {sim.ledger_nums()}"
        assert sim.all_ledgers_agree()
        hashes = [
            [headers.load_by_sequence(node.database, s).get_hash()
             for s in range(2, LEDGERS + 1)]
            for node in sim.nodes.values()
        ]
        return hashes, app.sig_backend.stats()
    finally:
        sim.stop_all_nodes()
        _clear_caches()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    hashes, _ = _consensus("stellar_tpu", tmp_path_factory.mktemp("jax"), "cpu")
    assert all(h == hashes[0] for h in hashes)
    return hashes[0]


def test_three_validators_match_jax(jax_run, tmp_path):
    from stellar_tpu_torch.ops import ed25519

    ed25519.plain_calls = 0
    hashes, stats = _consensus("stellar_tpu_torch", tmp_path, "gpu", SIG_DEVICE="cpu")
    assert hashes == [jax_run] * 3
    assert ed25519.plain_calls > 0 and stats["device_calls"] > 0
    assert stats["cpu_cutover_items"] == stats["stall_rejected_items"] == 0
    assert stats["wedge_latch_flips"] == {}


def test_three_validators_without_libsodium_match_jax(jax_run, tmp_path, monkeypatch):
    from stellar_tpu_torch.crypto import keys, sodium
    from stellar_tpu_torch.overlay.peerauth import PeerAuth

    def missing():
        raise RuntimeError("libsodium not found")

    monkeypatch.setattr(sodium, "_load", missing)
    # classify each eager ref25519 verify: a peer-auth certificate, or an
    # invalid signature — a valid tx or SCP signature must arrive as a
    # cache hit from the batch plane
    in_auth = threading.local()
    eager = []
    cert_check = PeerAuth.verify_remote_auth_cert

    def auth(self, remote, cert):
        in_auth.on = True
        try:
            return cert_check(self, remote, cert)
        finally:
            in_auth.on = False

    ref_verify = keys._verify_detached

    def recorded(signature, msg, key_raw):
        ok = ref_verify(signature, msg, key_raw)
        eager.append((getattr(in_auth, "on", False), ok))
        return ok

    monkeypatch.setattr(PeerAuth, "verify_remote_auth_cert", auth)
    monkeypatch.setattr(keys, "_verify_detached", recorded)
    keys.reset_stats()
    try:
        hashes, stats = _consensus("stellar_tpu_torch", tmp_path, "gpu", SIG_DEVICE="cpu")
        n_ref = keys.stats()["eager_ref_verifies"]
    finally:
        keys.reset_stats()
    assert hashes == [jax_run] * 3
    assert stats["device_calls"] > 0 and stats["wedge_latch_flips"] == {}
    assert n_ref == len(eager) > 0
    assert all(cert or not ok for cert, ok in eager), eager
    # each node's certificate is verified once: the three nodes share the
    # process-wide verify cache, so the other peer's check is a hit
    assert sum(cert for cert, _ in eager) >= 3
