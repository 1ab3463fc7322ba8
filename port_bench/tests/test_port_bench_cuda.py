"""The benchmark on the card: each cell's command at a short window, a
directory that holds only the benchmark's files, and the control at the
cell's own size.  Each test decides inside itself whether there is a card
and skips without one."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _cmd(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    p = _cmd(tiny.REPO, "port_bench.run", "--workload", cell, "--seed", str(2**31 + 99),
             "--seconds", "2", "--trace", trace)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], p.stderr[-4000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert p.stderr.strip().splitlines()[-2:] == ["mismatches 0 limit 0", "missing 0 limit 0"]
    read = {**res["readings"], **{k: v["value"] for k, v in res["metrics"].items()}}
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["ed25519_verify_roofline"]["value"] < 100
        assert 0 < res["metrics"]["step_mfu"]["value"] < 100
        assert ("sha512_h_roofline" in res["metrics"]) == ("devhash" in cell)
        assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
        assert 0 < read["verifies_per_s"] < read["card_verifies_per_s"]
    else:
        assert "busy_s" not in res["device"]
        assert set(res["metrics"]) == {"verifies_per_s", "setup_s"}
        assert read["verifies_per_s"] > 0


def test_the_benchmark_alone_prints_no_result(card, tmp_path):
    shutil.copytree(tiny.REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _cmd(tmp_path, "port_bench.run", "--workload", tiny.CELLS[0], "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_the_control_comes_out_not_correct_at_the_cells_size(card):
    p = _cmd(tiny.REPO, "port_bench.control", "--workload", tiny.CELLS[0], "--seeds", "5",
             "--seconds", "1", "--side", "control")
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert not res["correct"] and res["mismatches"] > 0 and res["compared"] >= 131072
