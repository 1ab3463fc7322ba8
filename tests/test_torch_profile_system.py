"""The port's system profilers (stellar_tpu_torch/profile_system.py) against
the root profile_system.py, on this CPU host.

The port runs with ``PROFILE_DEVICE=cpu``: its nodes verify on the gpu
backend with ``SIG_DEVICE = "cpu"`` (the verify kernel's plain version) and
its device bucket backend is ``device-cpu`` (the SHA-256 kernel's plain
version).  The JAX harness runs its nodes on libsodium, its directories
rooted in ``tmp_path``.  Sizes are tiny: a 2,000-account rung with 2 traffic
closes of 6 payments, 2,000-entry buckets, a 1 MB hash buffer, the least
autoload (100 accounts, 60 payments).

Tolerance: exact on every field compared —
- ``_rung(2000, traffic_closes=2, txs_per_close=6)``: ``accounts``,
  ``traffic_closes``, ``txs_per_close``, ``n_buckets``,
  ``bucket_bytes_total``, ``bucket_merge_bytes_in``, ``rehash_backend``, and
  of ``backends``: ``bit_identical``, ``device_buckets_covered`` and
  ``native_available``.  Both sides run with ``device_byte_budget=0``, so
  the JAX side compiles no XLA shape; the port's device leg over every
  bucket (the default budget) is held against hashlib and native in its own
  case.  ``device_backend`` is left out: ``device-cpu`` in the port,
  ``device-xla`` in the JAX package (a recorded contract difference);
- ``hash_ab(1)``: the device digests equal the host's (its own assertion)
  and the JAX package's hashlib over the same buffer; rc 0 or 1 by the gate;
- ``bucket(n=2000)``: both finish, with the same entry counts and merge
  engine;
- ``autoload(60)``: ``done`` and the applied count.  The port's node runs
  the gpu backend with ``GPU_CPU_CUTOVER = 2`` here: the tiny load's 160
  one-lane ingest batches then verify on the host (the plain version costs
  ~1 s a call on this CPU, ~160 s for the run); the card runs every batch
  on the verify kernel.
Left out, because they are times or rates: every ``*_s``, ``*_ms``,
``*_per_s``, ``*_per_sec`` field, the ladder's p50 ratio, hash_ab's MB/s
and ratio (and so which of rc 0 and 1 it gives), autoload's wall and
calibrated rate.

Also: ``ladder`` writes STATE_LADDER_torch.json (never the JAX package's
STATE_LADDER_r22.json) and gives rc 1 past the 1.5x ratio; without CUDA
and without ``PROFILE_DEVICE=cpu`` the CLI exits 2 with a line naming CUDA.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNG_FIELDS = ("accounts", "traffic_closes", "txs_per_close", "n_buckets",
               "bucket_bytes_total", "bucket_merge_bytes_in", "rehash_backend")
RUNG_BACKEND_FIELDS = ("bit_identical", "device_buckets_covered", "native_available")


@pytest.fixture
def both(tmp_path, monkeypatch):
    """(JAX profile_system, port profile_system), the JAX configs'
    directories in tmp_path, both verify caches cleared."""
    monkeypatch.setenv("PROFILE_DEVICE", "cpu")
    monkeypatch.syspath_prepend(REPO)
    jps = importlib.import_module("profile_system")
    from stellar_tpu_torch import profile_system as tps

    JT = importlib.import_module("stellar_tpu.tx.testutils")
    real = JT.get_test_config

    def own_dirs(instance=0, *a, **kw):
        cfg = real(instance, *a, **kw)
        cfg.BUCKET_DIR_PATH = str(tmp_path / f"jax-buckets-{instance}")
        cfg.TMP_DIR_PATH = str(tmp_path / f"jax-tmp-{instance}")
        return cfg

    monkeypatch.setattr(JT, "get_test_config", own_dirs)
    for pkg in ("stellar_tpu", "stellar_tpu_torch"):
        importlib.import_module(f"{pkg}.crypto.keys").PubKeyUtils.clear_verify_sig_cache()
    return jps, tps


def test_rung_matches_jax_on_every_non_time_field(both):
    jps, tps = both
    want = jps._rung(2000, traffic_closes=2, txs_per_close=6, device_byte_budget=0)
    got = tps._rung(2000, traffic_closes=2, txs_per_close=6, device_byte_budget=0)
    for key in RUNG_FIELDS:
        assert got[key] == want[key], key
    for key in RUNG_BACKEND_FIELDS:
        assert got["backends"][key] == want["backends"][key], key
    assert got["backends"]["bit_identical"] and got["n_buckets"] >= 2
    assert got["backends"]["device_buckets_covered"] == 0
    assert got["backends"]["device_backend"] == "device-cpu"
    assert want["backends"]["device_backend"] == "device-xla"


def test_rung_device_leg_covers_every_bucket(both):
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import sha256 as t256

    _, tps = both
    ed.plain_calls = t256.plain_calls = 0
    got = tps._rung(2000, traffic_closes=2, txs_per_close=6)
    ab = got["backends"]
    assert ab["bit_identical"] and "mismatch" not in ab
    assert ab["device_buckets_covered"] == got["n_buckets"] >= 2
    assert ab["device_mb_per_sec"] > 0 and ab["native_available"]
    # the traffic closes verified on the verify kernel's plain version and
    # the device leg hashed on the SHA-256 kernel's (one call a size class)
    assert ed.plain_calls > 0
    assert t256.plain_calls >= got["n_buckets"]


def test_hash_ab_device_digests_equal_host(both, capsys, monkeypatch):
    from stellar_tpu_torch.bucket import hashplane

    _, tps = both
    seen = []
    real = hashplane.DeviceBackend.hash_frames

    def hash_frames(self, buf):
        out = real(self, buf)
        seen.append((bytes(buf), out))
        return out

    monkeypatch.setattr(hashplane.DeviceBackend, "hash_frames", hash_frames)
    capsys.readouterr()
    rc = tps.hash_ab(1)
    out = capsys.readouterr().out
    m = re.search(r"host\[(\w+)\] [\d,.]+ MB/s; device\[device-cpu\] [\d,.]+ MB/s; "
                  r"ratio ([\d.]+)x \(gate: >= 2x\)", out)
    assert m, out
    assert rc == (0 if float(m.group(2)) >= 2.0 else 1)
    assert len(seen) == 4  # one warm-up and three timed runs
    jhp = importlib.import_module("stellar_tpu.bucket.hashplane")
    data, digest = seen[0]
    assert len(data) == (1 << 20) // 260 * 260
    assert digest == jhp.backend_by_name("hashlib").hash_frames(data)
    assert all(s == seen[0] for s in seen)


def test_bucket_finishes_as_jax(both, capsys):
    jps, tps = both
    capsys.readouterr()
    jps.bucket(2000)
    out_jax = capsys.readouterr().out
    tps.bucket(2000)
    out_port = capsys.readouterr().out
    pat = r"n=2000/bucket: fresh-write .* entries/s .*; (\S+) merge .* \((?:.*)s, (\d+) entries in\)"
    mj, mt = re.search(pat, out_jax), re.search(pat, out_port)
    assert mj and mt, (out_jax, out_port)
    assert mt.groups() == mj.groups() == ("C", "4200")


def test_autoload_applies_as_jax(both, capsys, monkeypatch):
    jps, tps = both
    from stellar_tpu_torch.tx import testutils as T

    real = T.get_test_config

    def host_cutover(*a, **kw):
        cfg = real(*a, **kw)
        cfg.GPU_CPU_CUTOVER = 2
        return cfg

    monkeypatch.setattr(T, "get_test_config", host_cutover)
    pat = r"mix=payments: done=(\w+) (\d+)/(\d+) txs applied in .* over (\d+) ledgers"
    capsys.readouterr()
    jps.autoload(60)
    mj = re.search(pat, capsys.readouterr().out)
    tps.autoload(60)
    mt = re.search(pat, capsys.readouterr().out)
    assert mj and mt
    assert mt.group(1, 2, 3) == mj.group(1, 2, 3) == ("True", "160", "160")


def test_ladder_writes_its_own_record(both, tmp_path, monkeypatch, capsys):
    _, tps = both
    monkeypatch.chdir(tmp_path)
    p50 = {10_000: 10.0, 100_000: 16.0}

    def rung(n):
        return {"accounts": n, "seed_entries_per_s": 1.0, "seed_s": 1.0, "close_p50_ms": p50[n],
                "catchup_rehash_mb_per_sec": 1.0, "rehash_backend": "native",
                "backends": {"bit_identical": True}}

    monkeypatch.setattr(tps, "_rung", rung)
    assert tps.ladder(100_000) == 1  # 1.6x > 1.5x
    doc = json.loads((tmp_path / "STATE_LADDER_torch.json").read_text())
    assert doc["close_p50_ratio_top_vs_bottom"] == 1.6
    assert set(doc["rungs"]) == {"10000", "100000"} and doc["device"] == "cpu"
    assert not (tmp_path / "STATE_LADDER_r22.json").exists()
    assert f"wrote {tmp_path / 'STATE_LADDER_torch.json'}" in capsys.readouterr().out
    p50[100_000] = 15.0
    assert tps.ladder(100_000) == 0


@pytest.mark.parametrize("args", [["hash_ab", "1"], ["bucket", "10"]])
def test_no_cuda_cli_exits_2_naming_cuda(args):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PROFILE_DEVICE"}
    r = subprocess.run([sys.executable, "-m", "stellar_tpu_torch.profile_system", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(env, PYTHONPATH=REPO))
    assert r.returncode == 2
    assert "CUDA" in r.stderr and r.stdout == ""
