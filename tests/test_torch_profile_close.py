"""The port's close profilers (stellar_tpu_torch/profile_close.py) against the
root profile_close.py, on this CPU host.

The port runs with ``PROFILE_DEVICE=cpu``: its node verifies on the gpu
backend with ``SIG_DEVICE = "cpu"``, so every txset check and flush runs the
verify kernel's plain PyTorch version (~1 s a call here, whatever the
batch).  The JAX harness runs its own node on libsodium (``backend="cpu"``),
its directories rooted in ``tmp_path`` (its test configs share ``/tmp`` paths
by instance with JAX tests in other workers).  Both packages' verify caches
are process-global and cleared before each case.  Sizes are tiny: 10-12
payments a close, 2 closes.

Each case runs the JAX function and its port on the same arguments.
Tolerance: exact on every field compared —
- ``_timed_close_run``: the final ledger hash;
- ``cowab`` (PARANOID) and ``fcab``: each leg's final ledger hash, read as
  its node stops, and the printed "final ledger hashes match";
- ``pipeline_report``: the legs' hashes, SQL dumps and history metas equal
  inside the port (its own assertions), its final hashes equal to the JAX
  run's, and the pipeline's dispatched and joined counts;
- ``ladder(scales=(200,))``: the entry cache's hit rate;
- ``copy_report``: the xdr_copy count, seals and CoW copies per tx, and
  every call site's count;
- ``apply_report``: the scheduler's line (closes, share of txs in parallel
  groups, conflict fallbacks, escapes) and the per-shard tx counts;
- ``assert_budget``: rc 0 under a large budget, rc 1 under 0, and rc 1 with
  the leak line in a process that imported ``stellar_tpu_torch.analysis``.
Left out, because they are times or a verdict on times: every p50, phase
ms, hidden/join-wait/dispatch ms, the sig-verify residual and its
reduction (and so ``pipeline_report``'s rc), the pipeline's warm-join count
(whether a prewarm finished before its join is a race), the populate
seconds, the apply-phase wall ratio and the budget's pass/fail under a
finite budget.

Also: without CUDA and without ``PROFILE_DEVICE=cpu`` the CLI exits 2 with
a line naming CUDA; the payments signed over the ref25519 pool (the card's
machine has no libsodium) are byte for byte the libsodium-signed ones.
"""

from __future__ import annotations

import importlib
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TXS, N_LEDGERS = 12, 2
PKGS = ("stellar_tpu", "stellar_tpu_torch")


@pytest.fixture
def both(tmp_path, monkeypatch):
    """(JAX profile_close, port profile_close, {package: [last closed hash
    of each node as it stops]}), the JAX configs' directories in tmp_path,
    both verify caches cleared."""
    monkeypatch.setenv("PROFILE_DEVICE", "cpu")
    monkeypatch.syspath_prepend(REPO)
    jpc = importlib.import_module("profile_close")
    from stellar_tpu_torch import profile_close as tpc

    JT = importlib.import_module("stellar_tpu.tx.testutils")
    real = JT.get_test_config

    def own_dirs(instance=0, *a, **kw):
        cfg = real(instance, *a, **kw)
        cfg.BUCKET_DIR_PATH = str(tmp_path / f"jax-buckets-{instance}")
        cfg.TMP_DIR_PATH = str(tmp_path / f"jax-tmp-{instance}")
        return cfg

    monkeypatch.setattr(JT, "get_test_config", own_dirs)
    hashes = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        app_cls = importlib.import_module(f"{pkg}.main.application").Application
        stop = app_cls.graceful_stop

        def graceful_stop(self, _stop=stop, _pkg=pkg):
            hashes[_pkg].append(self.ledger_manager.last_closed.hash)
            return _stop(self)

        monkeypatch.setattr(app_cls, "graceful_stop", graceful_stop)
        importlib.import_module(f"{pkg}.crypto.keys").PubKeyUtils.clear_verify_sig_cache()
    return jpc, tpc, hashes


def _run(fn, capsys, *args, **kwargs):
    capsys.readouterr()
    rc = fn(*args, **kwargs)
    return rc, capsys.readouterr().out


def test_timed_close_run_final_hash_matches(both):
    jpc, tpc, _ = both
    _, h_jax = jpc._timed_close_run(90, N_TXS, N_LEDGERS)
    _, h_port = tpc._timed_close_run(90, N_TXS, N_LEDGERS)
    assert h_port == h_jax


@pytest.mark.parametrize("mode", ["cowab", "fcab"])
def test_knob_ab_legs_match_each_other_and_jax(both, capsys, mode):
    jpc, tpc, hashes = both
    _, out_jax = _run(getattr(jpc, mode), capsys, N_TXS, N_LEDGERS)
    _, out_port = _run(getattr(tpc, mode), capsys, N_TXS, N_LEDGERS)
    assert "final ledger hashes match" in out_jax
    assert "final ledger hashes match" in out_port
    assert len(hashes["stellar_tpu_torch"]) == 2
    assert hashes["stellar_tpu_torch"] == hashes["stellar_tpu"]


def _pipeline_counts(out):
    m = re.search(r"pipeline: dispatched (\d+), joined (\d+) \(warm \d+\)", out)
    assert m, out
    return int(m.group(1)), int(m.group(2))


def test_pipeline_report_matches_jax(both, capsys):
    jpc, tpc, hashes = both
    _, out_jax = _run(jpc.pipeline_report, capsys, N_TXS, N_LEDGERS)
    rc, out_port = _run(tpc.pipeline_report, capsys, N_TXS, N_LEDGERS)
    assert rc in (0, 1)  # the 80 % reduction gate: a verdict on times
    assert "final ledger hashes + SQL dumps + history metas bit-exact" in out_port
    assert len(hashes["stellar_tpu_torch"]) == 2
    assert hashes["stellar_tpu_torch"] == hashes["stellar_tpu"]
    assert _pipeline_counts(out_port) == _pipeline_counts(out_jax) == (N_LEDGERS - 1,) * 2
    for tag in ("ON", "OFF"):
        assert f"== pipeline {tag}:" in out_port


def test_ladder_hit_rate_matches_jax(both):
    jpc, tpc, _ = both
    [(scale_j, _, hit_j, _)] = jpc.ladder(scales=(200,), n_txs=10, n_ledgers=2)
    [(scale_t, _, hit_t, _)] = tpc.ladder(scales=(200,), n_txs=10, n_ledgers=2)
    assert scale_t == scale_j == 200
    assert hit_t == hit_j


def _copy_sections(out):
    """{tag: (headline, [(calls, site)])} of copy_report's output."""
    sections, tag = {}, None
    for line in out.splitlines():
        m = re.match(r"== (CoW \w+): (.*) ==$", line)
        if m:
            tag = m.group(1)
            sections[tag] = (m.group(2), [])
        elif tag and re.match(r"\s+[\d,]+\s+[\d.]+/tx\s+\S", line):
            calls, _per_tx, site = line.split(None, 2)
            sections[tag][1].append((calls, site))
    return sections


def test_copy_report_sites_match_jax(both, capsys):
    jpc, tpc, _ = both
    _, out_jax = _run(jpc.copy_report, capsys, N_TXS, N_LEDGERS)
    _, out_port = _run(tpc.copy_report, capsys, N_TXS, N_LEDGERS)
    want, got = _copy_sections(out_jax), _copy_sections(out_port)
    assert set(want) == {"CoW ON", "CoW OFF"}
    assert all(sites for _, sites in want.values())
    assert got == want
    assert "final ledger hashes match" in out_port


def _apply_fields(out):
    sched = re.findall(r"scheduler: .*", out)
    shards = re.findall(r"shard (\d+):\s+(\d+) txs", out)
    return sched, shards


def test_apply_report_shards_match_jax(both, capsys):
    jpc, tpc, hashes = both
    rc_jax, out_jax = _run(jpc.apply_report, capsys, N_TXS, N_LEDGERS, 4)
    rc_port, out_port = _run(tpc.apply_report, capsys, N_TXS, N_LEDGERS, 4)
    sched, shards = _apply_fields(out_jax)
    assert sched and shards
    assert _apply_fields(out_port) == (sched, shards)
    assert hashes["stellar_tpu_torch"] == hashes["stellar_tpu"]
    assert "final ledger hashes + SQL dumps + history metas bit-exact" in out_port
    # 1 only when the parallel leg never sharded (the wall ratio's gate
    # reads times, so rc may also differ on a host of 4 cores or more)
    assert "never sharded" not in out_port + out_jax


def test_assert_budget_gate_and_leak_check(both, capsys, monkeypatch):
    _, tpc, _ = both
    # another test in this worker may have imported the analysis package:
    # the in-process cases run without it, the subprocess below with it
    for name in [m for m in sys.modules if m.startswith("stellar_tpu_torch.analysis")]:
        monkeypatch.delitem(sys.modules, name)
    rc, out = _run(tpc.assert_budget, capsys, 1e9, N_TXS, N_LEDGERS)
    assert rc == 0 and "OK" in out
    assert "analysis plane: not imported by the close path" in out
    rc, out = _run(tpc.assert_budget, capsys, 0.0, N_TXS, N_LEDGERS)
    assert rc == 1 and "EXCEEDED" in out
    code = (
        "import sys, stellar_tpu_torch.analysis\n"
        "from stellar_tpu_torch import profile_close as p\n"
        f"sys.exit(p.assert_budget(1e9, {N_TXS}, {N_LEDGERS}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert r.returncode == 1, r.stderr[-2000:]
    assert "BUDGET GATE: stellar_tpu_torch.analysis leaked into the close-path" in r.stdout


def test_no_cuda_cli_exits_2_naming_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PROFILE_DEVICE"}
    r = subprocess.run([sys.executable, "-m", "stellar_tpu_torch.profile_close", "10", "2"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(env, PYTHONPATH=REPO))
    assert r.returncode == 2
    assert "CUDA" in r.stderr and r.stdout == ""


def test_pool_signed_payments_equal_libsodium_signed(both, monkeypatch):
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from stellar_tpu_torch import harness
    from stellar_tpu_torch.crypto import sodium

    _, tpc, _ = both
    from stellar_tpu_torch.tx import testutils as T

    app, clock = tpc._make_app(80, 5)
    try:
        accounts = [T.get_account(i + 1) for i in range(6)]
        created_at = {a.get_strkey_public(): 3 for a in accounts}
        want = [t.envelope.to_xdr() for t in tpc._payment_txs(app, accounts, created_at, 5, 1)]
        monkeypatch.setattr(sodium, "available", lambda: False)
        monkeypatch.setattr(harness, "_pool", ProcessPoolExecutor(
            max_workers=2, mp_context=mp.get_context("spawn")))
        try:
            got = tpc._payment_txs(app, accounts, created_at, 5, 1)
        finally:
            harness.close_pool()
        assert harness._pool is None
        assert [t.envelope.to_xdr() for t in got] == want
        assert all(len(t.envelope.signatures) == 1 for t in got)
    finally:
        app.graceful_stop()
        clock.shutdown()
