"""The port's bench (stellar_tpu_torch/bench.py) against the root bench.py,
on this CPU host (``BENCH_DEVICE=cpu``: the kernels' plain versions).

- The line: both ``main()``s in process on the same tiny knobs print one
  JSON line each; the port's key set (and the key sets of its nested
  dicts) equals the JAX line's, apart from the recorded differences
  (``libsodium`` and ``nvidia_smi`` on the line, ``backend`` in the
  half-aggregation dict).  The same two runs hold the legs equal field for
  field: the close (txs, ledgers, copies/seals/CoW copies per tx, apply
  workers and fallbacks, pipeline depth, mesh devices, bucket backend,
  ingest occupancy, and the last closed ledger's hash, read from the app
  when it stops), the byzantine flood (its rejects, the cache latching
  nothing, the send-queue sheds and high-water) and the envelope legs'
  counts.
- Without CUDA and without ``BENCH_DEVICE=cpu``: one ``error`` line naming
  CUDA, exit code 2, nothing measured.
- The watchdog's partial line; a hung close child killed while the
  headline stands.
- The pool-signed fixture (ref25519 in spawn workers, what the card's
  machine runs without libsodium) equals ``SecretKey.sign`` byte for byte.
- ``bench_scenario_liveness`` on one tier-1 class: the digest of both.

Tolerance: exact for every field compared.  Left out, because they are
times or rates (or a comparison of two times): ``value``, ``vs_baseline``,
every ``*_per_sec``, ``*_us_per_item`` and ``*_ms`` field,
``speedup_*``, ``device_hash_stage_gate_only``, ``bucket_hash_mb_per_sec``
and ``overlap_hidden_ms``; ``device`` (each package names its own device)
and ``ledger_close_sig_backend`` ("gpu" in the port, "cpu" in the JAX
package on this host: a recorded difference).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the test's knobs: both packages, one JSON line each
KNOBS = {
    "BENCH_DEVICE": "cpu",
    "BENCH_BATCH": "64",
    "BENCH_CHUNKS": "2",
    "BENCH_ITERS": "1",
    "BENCH_SCP_N": "64",
    "BENCH_SCP_AGG_N": "32",
    "BENCH_SCENARIOS": "0",
    "BENCH_CLOSE_TXS": "50",
    "BENCH_CLOSE_LEDGERS": "2",
    # the JAX bench's slow-window retry must not fire on CPU rates
    "BENCH_GOOD_RATE": "1",
    # never wait on another run's lock, never arm a watchdog that could
    # outlive the test in this process
    "BENCH_LOCK_WAIT": "0",
    "BENCH_WATCHDOG": "100000",
}
# the port's line adds these keys (ROADMAP, "Recorded contract differences")
PORT_ONLY = {"libsodium", "nvidia_smi"}
CLOSE_FIELDS = (
    "ledger_close_txs", "ledger_close_ledgers", "xdr_copies_per_tx", "cow_seals_per_tx",
    "cow_copies_per_tx", "apply_workers", "apply_parallel_pct", "apply_conflict_fallbacks",
    "close_pipeline_depth", "sig_mesh_devices", "bucket_hash_backend", "ingest_batch_occupancy",
)
LINE_FIELDS = ("metric", "unit", "batch", "chunks", "iters", "host_stage", "device_hash",
               "scp_envelope_backend", "scp_envelope_n", "scp_envelope_scheme")
HALFAGG_FIELDS = ("scheme", "n", "slots", "agg_checks", "native_msm")
SENDQ_FIELDS = ("sheds", "sendq_bytes_high_water", "cap_bytes", "critical_sheds")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def _run(env, timeout=240):
    r = subprocess.run([sys.executable, "-m", "stellar_tpu_torch.bench"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, (r.stdout, r.stderr[-2000:])
    return r.returncode, json.loads(lines[0]), r.stderr


def _main_line(mod, capsys):
    capsys.readouterr()
    try:
        mod.main()
    finally:
        # the flock outlives main(): release it for the other tests' runs
        if mod._bench_lock is not None:
            mod._bench_lock.close()
            mod._bench_lock = None
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_line_and_legs_match_the_jax_bench(tmp_path, monkeypatch, capsys):
    import importlib

    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.syspath_prepend(REPO)
    jbench = importlib.import_module("bench")
    from stellar_tpu_torch import bench as tbench

    # the JAX close node's directories in tmp_path (the JAX test configs
    # share /tmp paths by instance with tests in other workers)
    JT = importlib.import_module("stellar_tpu.tx.testutils")
    real = JT.get_test_config

    def own_dirs(instance=0, *a, **kw):
        cfg = real(instance, *a, **kw)
        cfg.BUCKET_DIR_PATH = str(tmp_path / f"jax-buckets-{instance}")
        cfg.TMP_DIR_PATH = str(tmp_path / f"jax-tmp-{instance}")
        return cfg

    monkeypatch.setattr(JT, "get_test_config", own_dirs)
    # the last closed ledger's hash of each close node, read as it stops
    hashes = {}
    for pkg in ("stellar_tpu", "stellar_tpu_torch"):
        app_cls = importlib.import_module(f"{pkg}.main.application").Application
        stop = app_cls.graceful_stop

        def graceful_stop(self, _stop=stop, _pkg=pkg):
            hashes[_pkg] = self.ledger_manager.last_closed.hash
            return _stop(self)

        monkeypatch.setattr(app_cls, "graceful_stop", graceful_stop)
        importlib.import_module(f"{pkg}.crypto.keys").PubKeyUtils.clear_verify_sig_cache()
    monkeypatch.setattr(jbench, "_emitted", False)

    jax_line = _main_line(jbench, capsys)
    port_line = _main_line(tbench, capsys)

    assert "error" not in port_line and "watchdog" not in port_line, port_line
    assert port_line["value"] > 0 and port_line["device"] == "cpu"
    assert port_line["nvidia_smi"] is None and port_line["libsodium"] is True
    assert set(port_line) - PORT_ONLY == set(jax_line), (
        set(port_line) ^ set(jax_line))
    for key in ("host_stage_us_per_item", "phase_breakdown_ms", "invariant_overhead_ms",
                "bucket_hash_mb_per_sec"):
        assert set(port_line[key]) == set(jax_line[key]), key
    assert set(port_line["scp_envelope_halfagg"]) - {"backend"} == set(jax_line["scp_envelope_halfagg"])

    for key in LINE_FIELDS + CLOSE_FIELDS:
        assert port_line[key] == jax_line[key], key
    for key in HALFAGG_FIELDS:
        assert port_line["scp_envelope_halfagg"][key] == jax_line["scp_envelope_halfagg"][key], key
    assert port_line["scp_envelope_halfagg"]["backend"] == "cpu"
    assert port_line["ledger_close_sig_backend"] == "gpu"
    assert hashes["stellar_tpu_torch"] == hashes["stellar_tpu"] and len(hashes) == 2

    # the flood leg (not on the line: each package keeps it in _progress)
    jf, tf = jbench._progress["byzantine_flood"], tbench._progress["byzantine_flood"]
    assert tf["n"] == jf["n"] == 64
    assert tf["cache_latched_invalid"] == jf["cache_latched_invalid"] == 0
    assert tf["backend"] == "gpu"
    for key in SENDQ_FIELDS:
        assert tf["sendq"][key] == jf["sendq"][key], key


def test_no_cuda_is_an_error_line_not_a_cpu_run():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    rc, line, _ = _run(_env(), timeout=120)
    assert rc == 2
    assert "CUDA" in line["error"] and "'device'" in line["error"], line
    assert line["value"] == 0.0
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}


def test_watchdog_prints_the_partial_line():
    # 50 passes of four 2048-lane plain calls take minutes: the watchdog
    # fires mid-run, late enough (12 s) that the libsodium rate, taken in
    # the first seconds, is in hand on a loaded host
    rc, line, _ = _run(_env(BENCH_DEVICE="cpu", BENCH_BATCH="2048", BENCH_CHUNKS="4",
                            BENCH_ITERS="50", BENCH_SKIP_CLOSE="1", BENCH_SCENARIOS="0",
                            BENCH_SCP_N="256", BENCH_WATCHDOG="12"))
    assert rc == 2
    assert "watchdog" in line and line["metric"] == "ed25519_verifies_per_sec"
    # what was measured before it fired rides the line
    assert line["libsodium_single_core_per_sec"] > 0


def test_close_hang_is_killed_and_the_headline_stands():
    rc, line, err = _run(_env(BENCH_DEVICE="cpu", BENCH_BATCH="16", BENCH_CHUNKS="1",
                              BENCH_ITERS="1", BENCH_SCP_ENVS="0", BENCH_SCP_AGG="0",
                              BENCH_HOST_STAGE="0", BENCH_SCENARIOS="0",
                              BENCH_CLOSE_SUBPROC="1", BENCH_CLOSE_FAKE_HANG="1",
                              BENCH_CLOSE_TIMEOUT="5"))
    assert rc == 0, err[-2000:]
    assert line["value"] > 0
    assert "killed after 5s" in line["ledger_close_error"]
    assert "watchdog" not in line and "error" not in line


def test_pool_signed_fixture_equals_secret_key_sign():
    from stellar_tpu_torch import bench
    from stellar_tpu_torch.crypto import SecretKey, sodium

    assert sodium.available()  # the reference side signs with libsodium here
    jobs = [(i, b"bench message %08d" % i) for i in range(5)] + [(20_000_000, None)]
    with bench._signing_pool(2) as pool:
        got = bench._sign_pool(jobs, pool, chunk=2)
    want = []
    for i, msg in jobs:
        sk = SecretKey.pseudo_random_for_testing(i)
        want.append((sk.public_raw, msg, None if msg is None else sk.sign(msg)))
    assert got == want
    assert bench.bench_items(5) == want[:5]


def test_scenario_liveness_digest_matches_jax(tmp_path, monkeypatch):
    import importlib

    monkeypatch.syspath_prepend(REPO)
    jbench = importlib.import_module("bench")
    from stellar_tpu_torch import bench as tbench

    S = importlib.import_module("stellar_tpu.scenarios.scenario")
    real = S.get_test_config

    def own_dirs(instance=0, *a, **kw):
        cfg = real(instance, *a, **kw)
        cfg.BUCKET_DIR_PATH = str(tmp_path / f"jax-buckets-{instance}")
        cfg.TMP_DIR_PATH = str(tmp_path / f"jax-tmp-{instance}")
        return cfg

    monkeypatch.setattr(S, "get_test_config", own_dirs)
    out = {}
    for pkg, run in (("stellar_tpu", lambda: jbench.bench_scenario_liveness(only=["partition_heal"])),
                     ("stellar_tpu_torch", lambda: tbench.bench_scenario_liveness(
                         only=["partition_heal"], signature_backend="cpu"))):
        importlib.import_module(f"{pkg}.crypto.keys").PubKeyUtils.clear_verify_sig_cache()
        out[pkg] = run()["partition_heal"]
    j, t = out["stellar_tpu"], out["stellar_tpu_torch"]
    assert t["ok"] and j["ok"]
    for key in ("ledgers_closed", "invariant_violations", "digest"):
        assert t[key] == j[key], key
