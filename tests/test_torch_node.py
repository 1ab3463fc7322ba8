"""The port's validator node against the JAX package's, hash for hash, on
this CPU host: a standalone node closing ledgers, a stall on the close path,
and the CLI.

The JAX side runs ``SIGNATURE_BACKEND = "cpu"`` (libsodium), or under a
stall ``"tpu"`` with its verifier blocked (it finishes the batch on the
host; the port waits for the card).  The port runs
``"gpu"`` with ``SIG_DEVICE = "cpu"``: every batch verify goes through
GpuSigBackend → BatchVerifier → the verify kernel's plain PyTorch version
(``ed25519.plain_calls > 0``), and with ``DEVICE_HASH`` the SHA-512 stage's,
with ``DEVICE_BUCKET_HASH`` the bucket list's SHA-256 stage's.  Both
packages' verify caches are cleared before each leg (they are
process-global).  The 3-node consensus case is in
tests/test_torch_node_consensus.py.

The standalone shape follows bench.py's ledger close at a small size: a
MAX_TX_SET_SIZE upgrade and 65 accounts created by one root-signed tx, then
three ledgers of 64 single-signer payments from distinct accounts, the
second with one signature byte flipped.  Tolerance: exact — every ledger
header hash and bucket-list hash equal, the same txset verdicts, and the bad
tx's result code ``txBAD_AUTH`` on both.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAY = 64
ROUNDS = 3
BAD_ROUND, BAD_INDEX = 1, 5


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _clear_caches():
    for pkg in ("stellar_tpu", "stellar_tpu_torch"):
        _m(pkg, "crypto.keys").PubKeyUtils.clear_verify_sig_cache()


class Node:
    """A standalone node of either package, driven by hand (bench.py's
    close loop): txsets built, checked and closed one by one."""

    def __init__(self, pkg, tmp, backend, **knobs):
        self.pkg = pkg
        T = self.T = _m(pkg, "tx.testutils")
        clock_m = _m(pkg, "util.clock")
        cfg = T.get_test_config(0, backend=backend)
        cfg.BUCKET_DIR_PATH = str(tmp / "buckets")
        cfg.TMP_DIR_PATH = str(tmp / "tmp")
        cfg.DESIRED_MAX_TX_PER_LEDGER = 4 * N_PAY
        for k, v in knobs.items():
            setattr(cfg, k, v)
        self.app = _m(pkg, "main.application").Application.create(
            clock_m.VirtualClock(clock_m.VIRTUAL_TIME), cfg, new_db=True
        )
        self.lm = self.app.ledger_manager
        self.root = T.root_key_for(self.app)
        self.accounts = [T.get_account(i + 1) for i in range(N_PAY + 1)]

    def txset(self, txs):
        ts = _m(self.pkg, "herder.txset").TxSetFrame(self.lm.last_closed.hash, txs)
        ts.sort_for_hash()
        return ts

    def close(self, txset, upgrades=()):
        sv = _m(self.pkg, "xdr.ledger").StellarValue(
            txset.get_contents_hash(),
            self.lm.last_closed.header.scpValue.closeTime + 5,
            list(upgrades),
            0,
        )
        self.lm.close_ledger(
            _m(self.pkg, "herder.ledgerclose").LedgerCloseData(
                self.lm.current.header.ledgerSeq, txset, sv
            )
        )
        h = self.lm.last_closed.header
        return h.ledgerSeq, self.lm.last_closed.hash, h.bucketListHash

    def create_accounts(self):
        X = _m(self.pkg, "xdr.ledger")
        up = _m(self.pkg, "xdr.base").xdr_to_opaque(
            X.LedgerUpgrade(X.LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE, 4 * N_PAY)
        )
        tx = self.T.tx_from_ops(
            self.app, self.root, 1,
            [self.T.create_account_op(a, 10**10) for a in self.accounts],
        )
        ts = self.txset([tx])
        assert ts.check_valid(self.app)
        row = self.close(ts, [up])
        self.created_at = self.lm.last_closed.header.ledgerSeq
        return row

    def payments(self, round_idx, bad_index=None):
        txs = []
        for i in range(N_PAY):
            seq = (self.created_at << 32) + 1 + round_idx
            tx = self.T.tx_from_ops(
                self.app, self.accounts[i], seq,
                [self.T.payment_op(self.accounts[i + 1], 1000)],
            )
            if i == bad_index:
                ds = tx.envelope.signatures[0]
                ds.signature = bytes([ds.signature[0] ^ 1]) + ds.signature[1:]
                tx.clear_cached()
            txs.append(tx)
        return txs


def _standalone(pkg, tmp, backend, **knobs):
    """The standalone shape; returns the closed ledgers, the txset verdicts
    and the bad tx's result code."""
    _clear_caches()
    node = Node(pkg, tmp, backend, **knobs)
    try:
        rows = [node.create_accounts()]
        verdicts, bad_code = [], None
        for r in range(ROUNDS):
            txs = node.payments(r, BAD_INDEX if r == BAD_ROUND else None)
            ts = node.txset(txs)
            verdicts.append(ts.check_valid(node.app))
            rows.append(node.close(ts))
            if r == BAD_ROUND:
                bad_code = txs[BAD_INDEX].get_result_code().name
                assert all(t.get_result_code().name == "txSUCCESS"
                           for j, t in enumerate(txs) if j != BAD_INDEX)
        return {"ledgers": rows, "verdicts": verdicts, "bad": bad_code}
    finally:
        node.app.graceful_stop()
        _clear_caches()


@pytest.fixture(scope="module")
def jax_close(tmp_path_factory):
    return _standalone("stellar_tpu", tmp_path_factory.mktemp("jax"), "cpu")


LEGS = {
    "host_hash": {},
    "device_hash": {"DEVICE_HASH": True},
    "device_bucket_hash": {"DEVICE_BUCKET_HASH": True},
}


@pytest.mark.parametrize("leg", list(LEGS))
def test_standalone_close_matches_jax(leg, jax_close, tmp_path):
    from stellar_tpu_torch.bucket import hashplane
    from stellar_tpu_torch.ops import ed25519, sha256, sha512

    ed25519.plain_calls = sha512.plain_calls = sha256.plain_calls = 0
    hashplane.reset_backend_cache()
    try:
        got = _standalone("stellar_tpu_torch", tmp_path, "gpu", SIG_DEVICE="cpu", **LEGS[leg])
    finally:
        hashplane.reset_backend_cache()
    assert got["ledgers"] == jax_close["ledgers"]
    assert [seq for seq, _, _ in got["ledgers"]] == [2, 3, 4, 5]
    assert got["verdicts"] == jax_close["verdicts"] == [True, False, True]
    assert got["bad"] == jax_close["bad"] == "txBAD_AUTH"
    assert ed25519.plain_calls > 0
    assert (sha512.plain_calls > 0) == (leg == "device_hash")
    assert (sha256.plain_calls > 0) == (leg == "device_bucket_hash")


def test_stall_on_the_close_path_commits_nothing(tmp_path, monkeypatch):
    """A card that never answers within DEVICE_GIVE_UP raises
    DeviceStallError out of the close: the pipelined prewarm of the next
    ledger is given up and quarantined, then that ledger's close gives up
    on its own inline prewarm.  Nothing of the aborted ledger is
    committed, and no batch is verified on the host."""
    from stellar_tpu_torch.crypto.sigbackend import DeviceStallError

    _clear_caches()
    node = Node("stellar_tpu_torch", tmp_path, "gpu", SIG_DEVICE="cpu")
    app, lm = node.app, node.lm
    inner = app.sig_backend.inner
    release = threading.Event()
    try:
        node.create_accounts()
        ts0 = node.txset(node.payments(0))
        assert ts0.check_valid(app)  # warms the cache: ledger 3 needs no dispatch
        # the plain verifier blocks until released; the budgets are tiny
        verify = inner._verifier.verify

        def blocking(items):
            release.wait(120)
            return verify(items)

        monkeypatch.setattr(inner._verifier, "verify", blocking)
        monkeypatch.setattr(inner, "DEVICE_TIMEOUT", 0.2)
        monkeypatch.setattr(inner, "DEVICE_FIRST_TIMEOUT", 0.2)
        monkeypatch.setattr(inner, "DEVICE_GIVE_UP", 0.4)
        txs1 = node.payments(1)
        pipe = app.close_pipeline
        pipe.note_upcoming(txs1)
        seq0, hash0, buckets0 = node.close(ts0)  # dispatches ledger 4's prewarm
        assert pipe.stats()["dispatched"] == 1
        db = app.database
        rows0 = {t: db.query_one(f"SELECT COUNT(*) FROM {t}")[0]
                 for t in ("ledgerheaders", "txhistory", "txfeehistory")}
        bl0 = app.bucket_manager.bucket_list.get_hash()
        with pytest.raises(DeviceStallError):
            node.close(node.txset(txs1))
        assert lm.last_closed.hash == hash0 and lm.last_closed.header.ledgerSeq == seq0
        assert lm.current.header.ledgerSeq == seq0 + 1
        assert db.query_one(
            "SELECT COUNT(*) FROM ledgerheaders WHERE ledgerseq = ?", (seq0 + 1,)
        )[0] == 0
        assert {t: db.query_one(f"SELECT COUNT(*) FROM {t}")[0] for t in rows0} == rows0
        assert app.bucket_manager.bucket_list.get_hash() == bl0
        assert lm.last_closed.header.bucketListHash == buckets0
        st = pipe.stats()
        assert st["quarantined"] >= 1 and st["fallback"] == 1 and st["inflight"] == 0
        flips = inner.stats()["wedge_latch_flips"]
        assert flips.get("pipeline") == 1 and flips.get("close") == 1
        # no verdict of the aborted ledger reached the shared cache
        cache = app.sig_backend.cache
        triples = [t for tx in txs1 for t in tx.candidate_signature_pairs(db)]
        assert triples and all(
            v is None for v in cache.peek_many(
                [cache.key_for(pk, sig, msg) for pk, msg, sig in triples]
            )
        )
    finally:
        release.set()
        app.graceful_stop()
        _clear_caches()


def _stalled_node(pkg, tmp, monkeypatch):
    """A node of either package on its device backend (the JAX package's
    "tpu" with cutover 0, the port's "gpu" on the plain version) with 0.2 s
    dispatch budgets, whose verifier outlives them: the JAX verifier
    blocks until released (the JAX backend finishes the batch on the
    host), the port's sleeps past the budget and then answers (the port
    waits for the card).  Every batch that reaches the device path stalls.
    Returns (node, release)."""
    if pkg == "stellar_tpu":
        node = Node(pkg, tmp, "tpu", TPU_CPU_CUTOVER=0)
    else:
        node = Node(pkg, tmp, "gpu", SIG_DEVICE="cpu")
    inner = node.app.sig_backend.inner
    release = threading.Event()

    def slow(real):
        def call(items):
            if pkg == "stellar_tpu":
                release.wait(120)
                raise RuntimeError("released after the test")
            time.sleep(0.3)
            return real(items)

        return call

    monkeypatch.setattr(inner._verifier, "verify", slow(inner._verifier.verify))
    monkeypatch.setattr(inner._verifier, "verify_torsion",
                        slow(inner._verifier.verify_torsion))
    monkeypatch.setattr(inner, "DEVICE_TIMEOUT", 0.2)
    monkeypatch.setattr(inner, "DEVICE_FIRST_TIMEOUT", 0.2)
    return node, release


def _stalled_closes(pkg, tmp, monkeypatch):
    """The standalone shape on a stalled node, each round's successor
    registered as the close pipeline's prewarm."""
    _clear_caches()
    node, release = _stalled_node(pkg, tmp, monkeypatch)
    app = node.app
    try:
        rows = [node.create_accounts()]
        rounds = [node.payments(r, BAD_INDEX if r == BAD_ROUND else None)
                  for r in range(ROUNDS)]
        verdicts = []
        for r, txs in enumerate(rounds):
            ts = node.txset(txs)
            verdicts.append(ts.check_valid(app))
            if r + 1 < ROUNDS:
                app.close_pipeline.note_upcoming(rounds[r + 1])
            rows.append(node.close(ts))
        bad = rounds[BAD_ROUND][BAD_INDEX].get_result_code().name
        return {"ledgers": rows, "verdicts": verdicts, "bad": bad,
                "stats": app.sig_backend.stats()}
    finally:
        release.set()
        app.graceful_stop()
        _clear_caches()


def test_stalled_closes_match_jax(jax_close, tmp_path, monkeypatch):
    """Every dispatch outlives its budget: the JAX node finishes its
    batches on the host, the port node waits for the card's (here the
    plain version's) verdicts.  Both close every ledger, with the same
    header and bucket-list hashes as the unstalled JAX node; the port
    counts its stalled items, latches nothing and verifies nothing on the
    host."""
    from stellar_tpu_torch.ops import ed25519

    jax = _stalled_closes("stellar_tpu", tmp_path / "jax", monkeypatch)
    ed25519.plain_calls = 0
    got = _stalled_closes("stellar_tpu_torch", tmp_path / "port", monkeypatch)
    assert got["ledgers"] == jax["ledgers"] == jax_close["ledgers"]
    assert got["verdicts"] == jax["verdicts"] == [True, False, True]
    assert got["bad"] == jax["bad"] == "txBAD_AUTH"
    assert jax["stats"]["wedge_fallback_items"] > 0
    st = got["stats"]
    assert ed25519.plain_calls > 0 and st["device_calls"] > 0
    assert st["stalled_items"] > 0 and st["device_dispatches"].get("close", 0) > 0
    assert st["stall_rejected_items"] == 0 and st["wedge_latch_flips"] == {}
    assert st["cpu_cutover_items"] == 0


def test_stalled_scp_envelope_reaches_the_herder(tmp_path, monkeypatch):
    """One SCP envelope through the overlay's batch flush under the 0.2 s
    budget: the batch stalls (the JAX node finishes it on the host, the
    port node waits for the card), and the envelope reaches the herder in
    both packages (an envelope with a flipped signature byte is rejected
    in both)."""
    seen, stats = {}, {}
    for pkg in ("stellar_tpu", "stellar_tpu_torch"):
        _clear_caches()
        node, release = _stalled_node(pkg, tmp_path / pkg, monkeypatch)
        app = node.app
        try:
            X = _m(pkg, "xdr.scp")
            herder = app.herder
            envs = []
            for flip in (False, True):
                st = X.SCPStatement(
                    nodeID=app.config.NODE_SEED.get_public_key(),
                    slotIndex=2,
                    pledges=X.SCPStatementPledges(
                        X.SCPStatementType.SCP_ST_CONFIRM,
                        X.SCPStatementConfirm(
                            herder.scp.local_qset_hash, 1, X.SCPBallot(1, b"stall"), 1
                        ),
                    ),
                )
                env = X.SCPEnvelope(statement=st, signature=b"")
                herder.sign_envelope(env)
                if flip:
                    env.signature = bytes([env.signature[0] ^ 1]) + env.signature[1:]
                envs.append(env)
            got, rejected = [], []
            monkeypatch.setattr(herder, "recv_scp_envelope", got.append)
            monkeypatch.setattr(herder, "note_envelope_rejected", rejected.append)
            om = app.overlay_manager
            for env in envs:
                om.enqueue_scp_envelope(env)
            om._flush_scp_batch()
            seen[pkg] = (got == envs[:1], rejected == envs[1:])
            stats[pkg] = app.sig_backend.stats()
        finally:
            release.set()
            app.graceful_stop()
            _clear_caches()
    assert seen["stellar_tpu_torch"] == seen["stellar_tpu"] == (True, True)
    assert stats["stellar_tpu"]["wedge_fallback_items"] == 2
    port = stats["stellar_tpu_torch"]
    assert port["stalled_items"] == 2 and port["device_dispatches"] == {"overlay": 1}
    assert port["stall_rejected_items"] == 0 and port["wedge_latch_flips"] == {}


def test_cli_newdb_on_a_gpu_node_on_the_cpu(tmp_path):
    """``python -m stellar_tpu_torch.main.cli --newdb --conf <node>`` for a
    gpu-backend validator on SIG_DEVICE = "cpu" creates the database."""
    from stellar_tpu_torch.crypto.keys import SecretKey

    key = SecretKey.pseudo_random_for_testing(4242)
    db = tmp_path / "node.db"
    conf = tmp_path / "node.cfg"
    conf.write_text(
        "HTTP_PORT = 0\n"
        "RUN_STANDALONE = true\n"
        "MANUAL_CLOSE = true\n"
        "NODE_IS_VALIDATOR = true\n"
        'NETWORK_PASSPHRASE = "port cli test network"\n'
        f'NODE_SEED = "{key.get_strkey_seed()}"\n'
        f'DATABASE = "sqlite3://{db}"\n'
        f'BUCKET_DIR_PATH = "{tmp_path / "buckets"}"\n'
        f'TMP_DIR_PATH = "{tmp_path / "tmp"}"\n'
        'SIGNATURE_BACKEND = "gpu"\n'
        'SIG_DEVICE = "cpu"\n'
        "[QUORUM_SET]\n"
        "THRESHOLD = 1\n"
        f'VALIDATORS = ["{key.get_strkey_public()}"]\n'
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "stellar_tpu_torch.main.cli", "--newdb", "--conf", str(conf)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert db.exists() and db.stat().st_size > 0
    r = subprocess.run(
        [sys.executable, "-m", "stellar_tpu_torch.main.cli", "--info", "--conf", str(conf)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "jax" not in r.stderr.lower()


def test_config_refuses_the_tpu_backend_and_a_mesh():
    """The tpu backend, a malformed mesh and an unknown device fail
    validation; SIG_MESH takes the JAX package's rule, so "auto" and a
    device count validate (whether the host has the devices is the boot's
    question)."""
    from stellar_tpu_torch.main.config import Config

    with pytest.raises(ValueError, match='"gpu"'):
        Config.from_dict({"SIGNATURE_BACKEND": "tpu"})
    with pytest.raises(ValueError, match="SIG_MESH"):
        Config.from_dict({"SIG_MESH": "all"})
    with pytest.raises(ValueError, match="SIG_DEVICE"):
        Config.from_dict({"SIG_DEVICE": "tpu"})
    cfg = Config.from_dict({"SIGNATURE_BACKEND": "gpu", "SIG_MESH": 1})
    assert cfg.SIG_DEVICE == "cuda" and cfg.GPU_CPU_CUTOVER == 0
    assert Config.from_dict({"SIG_MESH": "auto"}).SIG_MESH == "auto"
    assert Config.from_dict({"SIG_MESH": 2}).SIG_MESH == 2


def test_sig_mesh_on_one_device(tmp_path):
    """On one device (SIG_DEVICE "cpu" has one) SIG_MESH "auto" boots the
    unsharded path, and SIG_MESH = 2 fails the boot: a validator told to
    run 2-wide must not quietly run 1-wide."""
    node = Node("stellar_tpu_torch", tmp_path / "auto", "gpu", SIG_DEVICE="cpu", SIG_MESH="auto")
    try:
        st = node.app.sig_backend.stats()
        assert st["mesh_devices"] == 0 and node.app.sig_backend.inner._verifier.mesh is None
    finally:
        node.app.graceful_stop()
    with pytest.raises(ValueError, match="addressable"):
        Node("stellar_tpu_torch", tmp_path / "two", "gpu", SIG_DEVICE="cpu", SIG_MESH=2)


def test_default_config_is_the_gpu_backend_on_the_card():
    """A config that names no backend verifies on the card: the gpu backend
    on SIG_DEVICE "cuda", in Config, a loaded config and get_test_config
    alike, and make_backend's default kind is "gpu"."""
    import inspect

    from stellar_tpu_torch.crypto.sigbackend import make_backend
    from stellar_tpu_torch.main.config import Config
    from stellar_tpu_torch.tx.testutils import get_test_config

    for cfg in (Config(), Config.from_dict({}), get_test_config()):
        assert (cfg.SIGNATURE_BACKEND, cfg.SIG_DEVICE) == ("gpu", "cuda")
    assert inspect.signature(make_backend).parameters["kind"].default == "gpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host without CUDA")
def test_default_config_raises_without_cuda(tmp_path):
    """On a host without CUDA a default node refuses to boot: nothing falls
    back to the CPU."""
    from stellar_tpu_torch.main.application import Application
    from stellar_tpu_torch.tx.testutils import get_test_config
    from stellar_tpu_torch.util.clock import VIRTUAL_TIME, VirtualClock

    cfg = get_test_config()
    cfg.BUCKET_DIR_PATH, cfg.TMP_DIR_PATH = str(tmp_path / "buckets"), str(tmp_path / "tmp")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Application.create(VirtualClock(VIRTUAL_TIME), cfg, new_db=True)


@pytest.mark.cuda
def test_default_config_boots_on_the_card(tmp_path):
    """A default node boots on the card and its batch verifies launch the
    verify kernel: one valid and one flipped signature, verdicts exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from stellar_tpu_torch.crypto.sigbackend import GpuSigBackend
    from stellar_tpu_torch.main.application import Application
    from stellar_tpu_torch.ops import ed25519_cuda
    from stellar_tpu_torch.tx.testutils import get_account, get_test_config
    from stellar_tpu_torch.util.clock import VIRTUAL_TIME, VirtualClock

    cfg = get_test_config()
    cfg.BUCKET_DIR_PATH, cfg.TMP_DIR_PATH = str(tmp_path / "buckets"), str(tmp_path / "tmp")
    _clear_caches()
    app = Application.create(VirtualClock(VIRTUAL_TIME), cfg, new_db=True)
    try:
        inner = app.sig_backend.inner
        assert isinstance(inner, GpuSigBackend) and inner._verifier.device.type == "cuda"
        key = get_account(7)
        sig = key.sign(b"default node")
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        launches = ed25519_cuda.launches
        got = app.sig_backend.verify_batch(
            [(key.public_raw, b"default node", sig), (key.public_raw, b"default node", bad)])
        assert got == [True, False] and ed25519_cuda.launches > launches
    finally:
        app.graceful_stop()
        _clear_caches()


def test_profiler_endpoint_runs_torch_profiler(tmp_path):
    """``/profiler`` starts and stops ``torch.profiler`` around a verify
    batch and writes a Chrome trace."""
    import json

    node = Node("stellar_tpu_torch", tmp_path, "gpu", SIG_DEVICE="cpu")
    try:
        ch = node.app.command_handler
        out = tmp_path / "profile"
        assert ch.handle_profiler({"action": "start", "dir": str(out)})["status"] == "profiling"
        assert "error" in ch.handle_profiler({"action": "start"})
        key = node.accounts[0]
        assert node.app.sig_backend.verify_batch([(key.public_raw, b"m", key.sign(b"m"))]) == [True]
        assert ch.handle_profiler({"action": "stop"}) == {"status": "stopped", "dir": str(out)}
        assert json.loads((out / "trace.json").read_text())["traceEvents"]
        assert "error" in ch.handle_profiler({"action": "stop"})
    finally:
        node.app.graceful_stop()
        _clear_caches()
