"""The port's kernel profiler (stellar_tpu_torch/profile_kernel.py) against
the root profile_kernel.py, on this CPU host (``PROFILE_DEVICE=cpu``: the
kernels' plain versions, about a second a call here, so the sizes are
tiny: 16 lanes, one rep).

- ``main(16)`` and ``--ab``: the JAX lines (``batch N [tag]: kernel call
  best … ms (rtt … ms) -> net … ms = … verifies/s device-only`` and the
  signed-window gain line); ``signed`` None reads the
  ``STELLAR_TPU_SIGNED_WINDOWS`` constant;
- ``--device-hash-ab --batch 16 --reps 1`` through the CLI: rc 0 (no gate
  on the CPU), the record ``DEVICE_HASH_torch.json`` in the working
  directory with the key set of the committed ``DEVICE_HASH_r16.json``
  apart from the recorded renames (``jax_backend`` → ``device``, plus
  ``nvidia_smi``), the mixed-lane oracle exact on both layouts;
- ``mesh_curve([1, 2], 16, 1)`` on the ``[cpu] * n`` rig in child
  processes: the record's keys and each leg's equal to the committed
  ``MULTICHIP_r13.json``'s apart from the recorded renames (``device`` for
  ``jax_backend``, plus ``mesh``, ``launches`` and ``plain_calls``),
  ``effective_chips`` 1, every kernel's launches 0 (the plain versions ran),
  ``ok`` and rc by the JAX rule; a ``--cards`` leg past the host's devices
  is skipped, so not ok, rc 1;
- the ``ok`` / rc rule itself, against the JAX ``mesh_curve`` on the same
  scripted child outputs (its rule imports no JAX);
- ``--tpu`` → rc 2 naming ``--cards``; the JAX package's records are never
  written; without CUDA and without ``PROFILE_DEVICE=cpu``, rc 2 and a line
  naming CUDA for every mode.

Tolerance: exact on keys, verdicts, counts and the rule; times and rates
are left out.  The JAX ``device_hash_ab`` and ``mesh_curve`` are not rerun
(76 s of XLA compile a layout): their committed records stand for them.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from stellar_tpu_torch import harness  # noqa: E402
from stellar_tpu_torch import profile_kernel as tpk  # noqa: E402
from stellar_tpu_torch.ops import ed25519 as ted  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"batch 16 \[(unsigned|signed-window)\]: kernel call best [\d.]+ ms "
                  r"\(rtt [\d.]+ ms\) -> net [\d.]+ ms = [\d,]+ verifies/s device-only")
# the recorded renames against the JAX records
DH_RENAMES = ({"jax_backend"}, {"device", "nvidia_smi"})
LEG_RENAMES = ({"jax_backend"}, {"device", "mesh", "launches", "plain_calls"})


def _record(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _renamed(keys, renames):
    gone, added = renames
    return (set(keys) - gone) | added


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PROFILE_DEVICE", "cpu")


def test_main_prints_the_jax_line(on_cpu, capsys):
    out = tpk.main(16, reps=1)
    lines = capsys.readouterr().out.splitlines()
    assert LINE.fullmatch(lines[-1]) and "[unsigned]" in lines[-1]
    assert [leg["kernel"] for leg in out["legs"]] == ["plain"] and out["device"] == "cpu"


def test_main_signed_none_reads_the_signed_windows_knob(on_cpu, capsys, monkeypatch):
    monkeypatch.setattr(ted, "_SIGNED_WIN", True)
    out = tpk.main(16, reps=1)
    assert "[signed-window]" in capsys.readouterr().out.splitlines()[-1]
    assert out["legs"][0]["signed"] is True


def test_main_ab_prints_three_legs_and_the_gain(on_cpu, capsys):
    out = tpk.main(16, ab=True, reps=1)
    lines = capsys.readouterr().out.splitlines()
    legs = [LINE.fullmatch(ln) for ln in lines[-4:-1]]
    assert all(legs), lines
    assert [m.group(1) for m in legs] == ["unsigned", "signed-window", "unsigned"]
    assert re.fullmatch(r"signed-window gain vs best unsigned leg: [+-]\d+\.\d%", lines[-1])
    want = 1.0 - out["legs"][1]["net_ms"] / min(out["legs"][0]["net_ms"], out["legs"][2]["net_ms"])
    assert out["gain"] == pytest.approx(want)


def _cli(args, cwd=REPO, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PROFILE_DEVICE"}
    env.update(env_extra or {}, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "stellar_tpu_torch.profile_kernel", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_device_hash_ab_cli_on_the_cpu(tmp_path):
    r = _cli(["--device-hash-ab", "--batch", "16", "--reps", "1"], cwd=tmp_path,
             env_extra={"PROFILE_DEVICE": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["DEVICE_HASH_torch.json"]
    with open(tmp_path / "DEVICE_HASH_torch.json") as f:
        rec = json.load(f)
    assert json.loads(r.stdout.splitlines()[-1]) == rec
    assert set(rec) == _renamed(_record("DEVICE_HASH_r16.json"), DH_RENAMES)
    assert rec["mixed_oracle_exact_both_layouts"] is True
    assert (rec["device"], rec["kernel_backend"], rec["nvidia_smi"]) == ("cpu", "plain", None)
    assert (rec["batch"], rec["reps"], rec["floor"], rec["gated"]) == (16, 1, 0.9, False)
    assert rec["ok"] == (rec["rate_e2e_device_hash"] >= 0.9 * rec["rate_kernel_only"])
    assert rec["rate_kernel_only"] > 0 and rec["dispatch_rtt_ms"] >= 0


def test_mesh_curve_on_the_cpu_rig(on_cpu, tmp_path, capsys):
    out = tmp_path / "curve.json"
    rc = tpk.mesh_curve([1, 2], 16, 1, False, str(out))
    with open(out) as f:
        rec = json.load(f)
    jax_rec = _record("MULTICHIP_r13.json")
    assert set(rec) == set(jax_rec)
    assert not rec["failures"] and not rec["skipped_legs"], rec["failures"]
    for leg, n in zip(rec["legs"], (1, 2)):
        want = _renamed(jax_rec["legs"][0], LEG_RENAMES)
        assert set(leg) - {"tail"} == want
        assert (leg["n_devices"], leg["effective_chips"], leg["batch"]) == (n, 1, 16)
        assert leg["mesh"] == ["cpu"] * n and leg["sharded"] == (n > 1)
        assert leg["mixed_oracle_exact"] and leg["kernel_backend"] == "plain"
        assert leg["device_calls"] >= 1 and leg["plain_calls"]["ed25519"] >= 1
        assert leg["launches"] == dict.fromkeys(("ed25519_verify", "ed25519_verify_signed",
                                                 "ed25519_verify_signed_pair", "sha512_h"), 0)
    assert rec["oracle"].startswith("repeated-device rig ([cpu] * n")
    ret = rec["legs"][1]["verifies_per_sec_per_chip"] / rec["legs"][0]["verifies_per_sec_per_chip"]
    assert rec["per_chip_retention_at_max_devices"] == pytest.approx(ret)
    assert rec["ok"] == (ret >= 0.7) and rc == (0 if rec["ok"] else 1)
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"] == rec["ok"]


def test_mesh_curve_cards_past_the_host_is_skipped_and_not_ok(on_cpu, tmp_path):
    out = tmp_path / "cards.json"
    assert tpk.mesh_curve([2], 16, 1, True, str(out)) == 1
    with open(out) as f:
        rec = json.load(f)
    assert rec["skipped_legs"] == [2] and rec["ok"] is False
    assert rec["legs"] == [{"n_devices": 2, "skipped": "only 1 addressable device(s)"}]
    assert rec["harness"].endswith("--mesh-curve --cards") and rec["oracle"].startswith("cards")


def test_mesh_leg_alone_signs_its_own_fixtures(on_cpu, capsys):
    """``--mesh-leg`` without ``--fixtures`` (a leg run by hand): the same
    lanes as the curve's shared fixture, its own oracle check."""
    assert tpk.mesh_leg(1, 16, 1) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("MESH_LEG ")
    leg = json.loads(line[len("MESH_LEG "):])
    assert set(leg) == _renamed(_record("MULTICHIP_r13.json")["legs"][0], LEG_RENAMES)
    assert leg["mixed_oracle_exact"] and leg["batch"] == 16 and leg["sharded"] is False
    mixed, want, items = tpk._curve_fixtures(16)
    assert tpk._curve_fixtures(8)[0] == mixed[:8] and tpk._curve_fixtures(8)[2] == items[:8]


def _leg(n, rate):
    return {"n_devices": n, "verifies_per_sec_per_chip": rate}


@pytest.mark.parametrize("children", [
    [(0, _leg(1, 100.0)), (0, _leg(2, 80.0)), (0, _leg(4, 75.0))],   # retained
    [(0, _leg(1, 100.0)), (0, _leg(4, 60.0))],                       # under the floor
    [(0, _leg(1, 100.0))],                                           # a single point
    [(0, _leg(1, 100.0)), (0, {"n_devices": 2, "skipped": "only 1"})],
    [(0, _leg(1, 100.0)), (1, None), (0, _leg(4, 90.0))],            # a failed leg
])
def test_mesh_curve_ok_rule_equals_jax(on_cpu, tmp_path, monkeypatch, children):
    """The curve, retention, ok and rc of both harnesses on the same
    scripted children (the JAX rule imports no JAX)."""
    monkeypatch.syspath_prepend(REPO)
    jpk = importlib.import_module("profile_kernel")
    results = {}
    for mod, name in ((jpk, "jax.json"), (tpk, "port.json")):
        script = iter(children)

        def run(argv, **kw):
            rc, leg = next(script)
            line = f"MESH_LEG {json.dumps(leg)}\n" if leg else "Traceback: boom\n"
            return subprocess.CompletedProcess(argv, rc, line, "")

        monkeypatch.setattr(mod.subprocess, "run", run)
        out = tmp_path / name
        rc = (mod.mesh_curve([c[1]["n_devices"] if c[1] else 2 for c in children], 16, 1,
                             False, str(out)))
        with open(out) as f:
            results[name] = (rc, json.load(f))
    (jrc, j), (trc, t) = results["jax.json"], results["port.json"]
    assert trc == jrc and t["ok"] == j["ok"]
    assert t["verifies_per_sec_per_chip"] == j["verifies_per_sec_per_chip"]
    assert t["skipped_legs"] == j["skipped_legs"] and len(t["failures"]) == len(j["failures"])
    if j["per_chip_retention_at_max_devices"] is None:
        assert t["per_chip_retention_at_max_devices"] is None
    else:
        assert round(t["per_chip_retention_at_max_devices"], 3) == j["per_chip_retention_at_max_devices"]


def test_tpu_flag_exits_2_naming_cards(capsys):
    assert tpk._cli(["--mesh-curve", "--tpu"]) == 2
    assert "--cards" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["DEVICE_HASH_r16.json", "DEVICE_HASH_TPU_r16.json",
                                  "MULTICHIP_r13.json", "MULTICHIP_TPU_r13.json"])
def test_the_jax_records_are_never_written(on_cpu, tmp_path, name):
    path = str(tmp_path / name)
    with pytest.raises(ValueError, match="JAX package"):
        if name.startswith("DEVICE_HASH"):
            tpk.device_hash_ab(16, 1, path)
        else:
            tpk.mesh_curve([1], 16, 1, False, path)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("args", [["16"], ["--device-hash-ab"], ["--mesh-curve"]])
def test_no_cuda_cli_exits_2_naming_cuda(tmp_path, args):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = _cli(args, cwd=tmp_path)
    assert r.returncode == 2
    assert "CUDA" in r.stderr and r.stdout == "" and not os.listdir(tmp_path)


@pytest.mark.cuda
def test_the_three_modes_on_card(tmp_path, monkeypatch):
    """On the card: main's A/B/A launches B1 and the wide B1s past 2,112
    lanes, never the plain version; the device-hash A/B's oracle and record;
    the rig's curve over two shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import sha512_cuda as sc

    monkeypatch.delenv("PROFILE_DEVICE", raising=False)
    try:
        b1, b1s, plain = ec.launches, ec.signed_launches, ted.plain_calls
        out = tpk.main(4096, ab=True, reps=2)
        assert [leg["kernel"] for leg in out["legs"]] == ["unsigned", "wide", "unsigned"]
        assert ec.launches - b1 == 6 and ec.signed_launches - b1s == 3
        b2 = sc.launches
        assert tpk.device_hash_ab(512, 1, str(tmp_path / "dh.json")) in (0, 1)
        assert sc.launches > b2 and ted.plain_calls == plain
        with open(tmp_path / "dh.json") as f:
            rec = json.load(f)
        assert rec["kernel_backend"] == "cuda" and rec["gated"] is True
        tpk.mesh_curve([1, 2], 256, 1, False, str(tmp_path / "mc.json"))
        with open(tmp_path / "mc.json") as f:
            rec = json.load(f)
        assert not rec["failures"]
        for leg in rec["legs"]:
            assert leg["launches"]["ed25519_verify"] > 0, leg
            assert leg["plain_calls"] == {"ed25519": 0, "sha512": 0}, leg
    finally:
        harness.close_pool()
