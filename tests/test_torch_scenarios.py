"""The port's chaos plane (stellar_tpu_torch/scenarios) against the JAX
package's (stellar_tpu/scenarios), on this CPU host.

Every small-matrix class that tests/test_scenarios.py runs in tier-1 runs
through both packages on the cpu backend (libsodium; the port's specs ask
for it, since its test configs default to the gpu backend on the card),
same spec and seed, both verify caches cold.  For each virtual-clock class the two scoreboards
are equal: ``final_hash``, ``final_lcls``, ``ledgers_closed``, the verdict
counters (strict-gate fast rejects, ingest sheds, closeTime-gate
rejections, send-queue sheds) and the whole replay digest.  ``catchup_load``
runs on a real clock (archive subprocesses), which tests/test_scenarios.py
exempts from replay too: both runs must pass their floors and agree within
themselves.

Then the port's own classes and harness: ``byzantine_flood_gpu`` (the
flood on the gpu backend at cutover 0, here on the verify kernel's plain
version, ``sig_device="cpu"``) holds the cpu flood's ledger hashes with
every flooded envelope rejected and no stall; the kill sweep's
representative points recover bit-exact (its children asked for the cpu
backend), on the same control state as the JAX package's child.  Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

PKGS = ("stellar_tpu", "stellar_tpu_torch")
VIRTUAL = [
    "partition_heal",
    "byzantine_flood",
    "byzantine_flood_halfagg",
    "ingest_flood",
    "slow_lossy",
    "crash_restart",
    "hard_kill_mid_close",
    "slow_reader",
    "overload_storm",
    "clock_skew_within_slip",
    "clock_skew_beyond_slip",
    "asymmetric_partition",
    "targeted_flood_tier2",
]


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def jax_dirs_under_tmp(tmp_path, monkeypatch):
    """The JAX package's test configs share /tmp/stellar-tpu-test-* paths
    by instance number with tests/test_scenarios.py, which may run at the
    same time in another worker: root this module's JAX nodes in its own
    tmp_path (the port's configs are per process already)."""
    S = _m("stellar_tpu", "scenarios.scenario")
    real = S.get_test_config

    def own_dirs(instance=0, *a, **kw):
        cfg = real(instance, *a, **kw)
        cfg.BUCKET_DIR_PATH = str(tmp_path / f"jax-buckets-{instance}")
        cfg.TMP_DIR_PATH = str(tmp_path / f"jax-tmp-{instance}")
        return cfg

    monkeypatch.setattr(S, "get_test_config", own_dirs)


def _cold_caches():
    for pkg in PKGS:
        _m(pkg, "crypto.keys").verify_cache().clear()


def _spec(pkg, cls, **over):
    spec = _m(pkg, "scenarios.matrix").small_specs()[cls]
    return dataclasses.replace(spec, **over) if over else spec


def _run(pkg, spec, capture=None):
    """One scenario from a cold cache; ``capture(scn)`` runs on the live
    simulation when the target is reached (Scenario.run stops it)."""
    _cold_caches()
    scn = _m(pkg, "scenarios.scenario").Scenario(spec)
    if capture is not None:
        reached = scn._target_reached

        def check():
            done = reached()
            if done:
                capture(scn)
            return done

        scn._target_reached = check
    r = scn.run()
    assert r.ok, (pkg, spec.name, r.failures)
    assert r.scoreboard.invariant_violations == 0
    assert r.scoreboard.ledgers_agree and r.scoreboard.final_hash
    return r


def _verdicts(sb):
    return {
        "fast_rejects": sb.fast_rejects,
        "ingest_rejects": sb.ingest_rejects,
        "slip_rejects": (sb.slip_rejects_past, sb.slip_rejects_future),
        "sendq_sheds": sb.sendq_sheds,
        "stragglers": sb.sendq_straggler_disconnects,
    }


@pytest.mark.parametrize("cls", VIRTUAL)
def test_small_class_matches_jax(cls):
    jax = _run("stellar_tpu", _spec("stellar_tpu", cls)).scoreboard
    port = _run("stellar_tpu_torch",
                _spec("stellar_tpu_torch", cls, signature_backend="cpu")).scoreboard
    assert port.ledgers_closed == jax.ledgers_closed >= 10
    assert port.final_hash == jax.final_hash
    assert port.final_lcls == jax.final_lcls
    assert _verdicts(port) == _verdicts(jax)
    assert port.digest() == jax.digest()


def test_catchup_load_small_both_pass():
    """Real clock: no cross-run hash equality (the JAX replay test exempts
    it too); each package's run holds the class's floors."""
    for pkg in PKGS:
        sb = _run(pkg, _spec(pkg, "catchup_load", signature_backend="cpu")).scoreboard
        assert sb.ledgers_closed >= 10 and sb.recovery_ms is not None


def test_signature_backend_none_means_the_port_default():
    """A spec that names no backend keeps the port's test config default,
    the gpu backend on the card; a test asks for libsodium by name."""
    S = _m("stellar_tpu_torch", "scenarios.scenario")
    spec = _spec("stellar_tpu_torch", "byzantine_flood")
    assert spec.signature_backend is None and spec.sig_device == "cuda"
    cfg = S.Scenario(spec)._cfg(0)
    assert (cfg.SIGNATURE_BACKEND, cfg.SIG_DEVICE) == ("gpu", "cuda")
    cpu = S.Scenario(dataclasses.replace(spec, signature_backend="cpu"))._cfg(0)
    assert cpu.SIGNATURE_BACKEND == "cpu"
    gpu = S.Scenario(_spec("stellar_tpu_torch", "byzantine_flood_gpu", sig_device="cpu"))._cfg(0)
    assert (gpu.SIGNATURE_BACKEND, gpu.GPU_CPU_CUTOVER, gpu.SIG_DEVICE) == ("gpu", 0, "cpu")


def test_flood_rates_match_the_jax_tpu_leg():
    """``byzantine_flood_gpu`` floods at the JAX ``byzantine_flood_tpu``
    rates, small and big."""
    for specs in ("small_specs", "big_specs"):
        j = getattr(_m("stellar_tpu", "scenarios.matrix"), specs)()["byzantine_flood_tpu"]
        p = getattr(_m("stellar_tpu_torch", "scenarios.matrix"), specs)()["byzantine_flood_gpu"]
        assert p.faults[0].__dict__ == j.faults[0].__dict__
        assert (p.n_nodes, p.tier_n, p.topology, p.load_txs, p.target_ledgers) == (
            j.n_nodes, j.tier_n, j.topology, j.load_txs, j.target_ledgers)
        assert (p.signature_backend, p.gpu_cpu_cutover) == ("gpu", 0)
        assert (j.signature_backend, j.tpu_cpu_cutover) == ("tpu", 0)


@pytest.mark.slow  # 850 s on this CPU host: ~1 s a plain verify call; the card
# runs the big spec in chip_smoke.py's scenario_flood phase
def test_byzantine_flood_gpu_small_on_the_plain_version(monkeypatch):
    """The flood on the gpu backend at cutover 0, every overlay flush
    (honest SCP and the flood) through GpuSigBackend → BatchVerifier → the
    verify kernel's plain version: the cpu flood's ledgers, every flooded
    envelope rejected, the cache unpolluted, no stall."""
    from stellar_tpu_torch.ops import ed25519

    jax = _run("stellar_tpu", _spec("stellar_tpu", "byzantine_flood")).scoreboard
    spec = _spec("stellar_tpu_torch", "byzantine_flood_gpu", sig_device="cpu")
    flood = spec.faults[0]
    stats = {}

    def capture(scn):
        for raw, app in scn.sim.nodes.items():
            stats[raw.hex()[:8]] = app.sig_backend.stats()

    ed25519.plain_calls = 0
    scn_mod = _m("stellar_tpu_torch", "scenarios.scenario")
    real_build = scn_mod.Scenario._build

    def build(self):
        # the plain version on a loaded CPU host can outlast the card's
        # 15 s budget, which would count a stall (asserted 0 below)
        real_build(self)
        for app in self.sim.nodes.values():
            inner = app.sig_backend.inner
            inner.DEVICE_TIMEOUT = inner.DEVICE_FIRST_TIMEOUT = 600.0

    monkeypatch.setattr(scn_mod.Scenario, "_build", build)
    sb = _run("stellar_tpu_torch", spec, capture).scoreboard
    assert sb.ledgers_closed >= 10
    assert sb.fast_rejects == flood.n_envelopes > 200
    assert flood.assert_cache_unpolluted() == flood.n_envelopes
    assert ed25519.plain_calls > 0
    assert stats and all(s["device_calls"] > 0 for s in stats.values()), stats
    assert all(s["stalled_items"] == s["stall_rejected_items"] == 0
               and s["wedge_latch_flips"] == {} and s["cpu_cutover_items"] == 0
               and s["device_dispatches"].get("overlay", 0) > 0
               for s in stats.values()), stats
    # the same consensus as the cpu flood: the backend changes no verdict
    assert sb.final_hash == jax.final_hash and sb.final_lcls == jax.final_lcls


TIER1_POINTS = [
    "close.pre-commit",      # every durable close artifact staged, no COMMIT
    "bucket.fresh:write",    # + truncate/torn modes on the staged file
    "publish.commit-json:staged",  # mid-publish, post-fsync pre-rename
]


def test_kill_sweep_representative_points(tmp_path):
    """Twin of tests/test_killsweep.py: real subprocess hard-kills of the
    port's node (``-m stellar_tpu_torch.scenarios --kill-child``) at one
    point per plane, each resumed bit-exact on the control trajectory —
    and that control state equals the JAX package's child's."""
    from stellar_tpu.scenarios import killsweep as jks
    from stellar_tpu_torch.scenarios.killsweep import DEFAULT_TARGET, run_kill_sweep

    report = run_kill_sweep(points=TIER1_POINTS, base_dir=str(tmp_path / "port"),
                            log=lambda s: None, signature_backend="cpu")
    assert not report.get("error"), report
    assert report["ok"], [v for v in report["verdicts"] if not v["ok"]]
    assert {v["point"] for v in report["verdicts"]} == set(TIER1_POINTS)
    for v in report["verdicts"]:
        assert v["selfcheck"] in ("ok", "repaired"), v
        assert v["resumed_lcl"] == report["target_ledger"], v
    modes = {(v["point"], v["mode"]) for v in report["verdicts"]}
    assert ("bucket.fresh:write", "truncate") in modes
    assert ("bucket.fresh:write", "torn") in modes
    assert report["points_swept"] == sorted(TIER1_POINTS)
    assert len(report["points_hit"]) >= 25, report["points_hit"]
    assert set(report["points_unexercised"]) <= {"bucket.native-merge:staged"}
    wd = tmp_path / "jax-control"
    wd.mkdir()
    out = str(wd / "result.json")
    proc = jks._run_child(str(wd), DEFAULT_TARGET, out, {})
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out) as f:
        jax = json.load(f)
    assert report["control"] == {k: jax[k] for k in ("lcl_seq", "lcl_hash", "bucket_hash")}


def test_scenarios_cli_exit_codes():
    from stellar_tpu_torch.scenarios.__main__ import main

    assert main(["--only", "not_a_fault_class"]) == 2
    assert main(["--kill-sweep", "--points", "not.a.point"]) == 2


def test_scenarios_module_runs_one_class(tmp_path):
    """``python -m stellar_tpu_torch.scenarios --only CLS --json
    --signature-backend cpu``: the CI entry point, one small class on
    libsodium, exit 0."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-m", "stellar_tpu_torch.scenarios", "--only", "partition_heal",
         "--json", "--signature-backend", "cpu"],
        capture_output=True, text=True, cwd=repo, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo),
    )
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["ok"] and line["name"] == "partition_heal_small", line
