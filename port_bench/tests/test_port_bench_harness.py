"""The harness on the CPU, at the tiny size of ``tiny.py``, with the kernels'
plain versions: cell discovery from files, new mixes and metrics taken as
new files alone, the seed, the result's keys, the roofline's yardstick, the
device trace's reading, the modules a run loads, and the comparison that
decides ``correct`` against the control and the faults a cell can have."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench import cells, control, devtrace, generator, roofline, run
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=2**31 + 7, trace=False, build=None):
    return run.run_cell(str(root), cell, seed, 0.2, trace, device="cpu",
                        t0=time.monotonic(), build=build)


def test_cells_are_found_from_files():
    repo = str(tiny.REPO)
    bench = cells.benchmark(repo)
    assert {w["name"] for w in bench["workloads"]} == set(tiny.CELLS)
    for name in tiny.CELLS:
        cell = cells.find(repo, name)
        assert cell.chips == 1 and cell.mix["call_items"] == 131072
        assert cell.config["knobs"]["SIG_BATCH_MAX"] == 32768
        assert {m["name"] for m in cell.end_to_end} == {"verifies_per_s", "setup_s"}
        assert cell.config["environment"] == {"STELLAR_TPU_SIGHASH_THREADS": "1"}
        per_layer = {m["name"] for m in cell.per_layer}
        assert ("sha512_h_roofline" in per_layer) == cell.config["knobs"]["DEVICE_HASH"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(repo, m["name"]))
        assert callable(cells.entry(repo, cell.config["entry"]))
    with pytest.raises(KeyError):
        cells.find(repo, "no-such.cell")


def test_the_host_hash_cell_is_an_entry_alone(root):
    cell = cells.find(str(root), tiny.HOSTHASH)
    assert cell.config["knobs"]["DEVICE_HASH"] is False
    assert "sha512_h_roofline" not in {m["name"] for m in cell.per_layer}
    assert "ed25519_verify_roofline" in {m["name"] for m in cell.per_layer}


def test_a_new_mix_and_metric_are_new_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    pb = root / "port_bench"
    mix = json.loads((pb / "traffic" / "payments.json").read_text())
    mix.update(msg_bytes=200, bad_share=0.0)  # multi-block messages: the host hashes
    (pb / "traffic" / "longmsg.json").write_text(json.dumps(mix))
    (pb / "metrics" / "calls_made.py").write_text(
        "def read(ctx):\n    return float(len(ctx.call_ms))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sig32k-devhash.longmsg", "config": "sig32k-devhash",
                               "traffic": "longmsg", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["sig32k-devhash.longmsg"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, _ = _run(root, "sig32k-devhash.longmsg")
    assert res["correct"]
    assert res["metrics"]["calls_made"]["value"] == res["calls"] >= 1
    # a reader that another cell lists is never run in this one, even where
    # it would fail here
    (pb / "metrics" / "longmsg_only.py").write_text(
        "def read(ctx):\n    raise AssertionError('read outside its cell')\n")
    bench["per_layer"].append({"name": "longmsg_only", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "entry", "moves": "calls_made",
                               "workloads": ["sig32k-devhash.longmsg"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        other = _run(root, "sig32k-devhash.payments", trace=trace)[0]
        assert other["correct"]
        assert not {"calls_made", "longmsg_only"} & (set(other["metrics"]) | set(other["readings"]))


def test_pool_and_call_orders_are_fixed_by_the_seed(root):
    mix = cells.find(str(root), tiny.CELLS[0]).mix
    a, b, c = (generator.build(mix, s) for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert a.pool == b.pool and a.classes == b.classes
    assert all(np.array_equal(x, y) for x, y in zip(a.orders, b.orders))
    assert a.pool != c.pool
    # every order of every seed carries each pool triple equally often
    for t in (a, c):
        for o in t.orders:
            assert np.array_equal(np.bincount(o, minlength=len(t.pool)),
                                  np.full(len(t.pool), mix["call_items"] // mix["pool"]))
        assert sorted(t.classes) == sorted(a.classes)


@pytest.mark.parametrize("cell", tiny.CELLS + (tiny.HOSTHASH,))
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_is_correct_and_its_result_has_the_keys(root, cell, trace):
    res, lines = _run(root, cell, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 48 * res["calls"]
    assert res["compared"] == 48 * res["calls"]  # keep_every 1 at the tiny size
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # no device trace on the CPU, and no spans untraced: their readers read
    # nothing, here or in the readings
    host = {"batch_ms.p95", "step_mfu"}
    spans = {"drain_ms", "host_stage_ms", "dispatch_ms"}
    end_to_end = {"verifies_per_s", "setup_s"}
    assert set(res["metrics"]) == (host | spans if trace else end_to_end)
    assert set(res["readings"]) == (end_to_end if trace else host)
    assert "busy_s" not in res["device"]
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert all(v > 0 for v in res["readings"].values())
    assert lines[-2:] == ["mismatches 0 limit 0", "missing 0 limit 0"]


def test_main_without_a_card_prints_no_result(tmp_path, root):
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", tiny.CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=root, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(tiny.REPO)})
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the cuda tests cover the run")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_forbidden_module_is_loaded(root):
    code = (
        "import sys, time; from port_bench import run\n"
        f"run.run_cell({str(root)!r}, {tiny.CELLS[0]!r}, 3, 0.1, True, device='cpu',"
        " t0=time.monotonic())\n"
        "print(run.forbidden_modules(), sorted(m for m in sys.modules if m.split('.')[0]"
        " == 'stellar_tpu_torch')[:1])\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[] ['stellar_tpu_torch']"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "stellar_tpu_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stellar_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "stellar_tpu"]


def _trace(names, dur=1e-3):
    """A device trace of one op a name, ``dur`` long each, in a 1 s window."""
    ops = [(n, 0.1 + i * 0.01, 0.1 + i * 0.01 + dur) for i, n in enumerate(names)]
    return devtrace.DeviceTrace(1.0, dur * len(names), ops, [])


def test_the_roofline_count_does_not_depend_on_the_kernel():
    read = cells.reader(str(tiny.REPO), "ed25519_verify_roofline")
    values = []
    for kernel in ("void (anonymous namespace)::ed25519_verify_kernel<false>(unsigned char const*)",
                   "void (anonymous namespace)::ed25519_verify_kernel<true>(unsigned char const*)",
                   "ed25519_verify_signed_pair_kernel(unsigned char const*, int)"):
        ctx = SimpleNamespace(device=_trace([kernel, "Memcpy HtoD (Pinned -> Device)"]),
                              lanes={"gate_ok": 32768, "one_block": 32768})
        values.append(read(ctx))
    assert values[0] == values[1] == values[2]
    least = 32768 * roofline.B1_OPS_PER_LANE / roofline.INT32_PER_S
    assert values[0] == pytest.approx(100 * least / 1e-3)
    assert roofline.B1_OPS_PER_LANE == 383560 and roofline.B2_OPS_PER_LANE == 4256
    # the B2 reader reads nothing where no B2 kernel ran
    sha = cells.reader(str(tiny.REPO), "sha512_h_roofline")
    assert sha(ctx) is None
    assert sha(SimpleNamespace(device=_trace(["sha512_h_kernel(unsigned char const*)"]),
                               lanes={"gate_ok": 10, "one_block": 10})) > 0


def test_device_trace_reading():
    events = [
        {"name": devtrace.WINDOW, "ph": "X", "cat": "user_annotation", "ts": 1000.0, "dur": 1000.0},
        {"name": "k1", "ph": "X", "cat": "kernel", "ts": 900.0, "dur": 200.0},      # clipped to 100
        {"name": "k1", "ph": "X", "cat": "kernel", "ts": 1150.0, "dur": 100.0},
        {"name": "Memcpy HtoD", "ph": "X", "cat": "gpu_memcpy", "ts": 1200.0, "dur": 100.0},
        {"name": "cpu", "ph": "X", "cat": "cpu_op", "ts": 1500.0, "dur": 100.0},    # not the card
        {"name": "k2", "ph": "X", "cat": "kernel", "ts": 1900.0, "dur": 300.0},     # clipped to 100
    ]
    t = devtrace.parse(events, mono0=50.0)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    assert [(round(a - 50.0, 7), round(b - 50.0, 7)) for a, b in t.gaps] == [
        (0.0001, 0.00015), (0.0003, 0.0009)]
    spans = devtrace.SpanIndex([("ed25519.host_hash", 50.0002, 50.0008), ("port_bench.call", 50.0, 50.001)])
    bd = devtrace.breakdown(t, spans)
    assert bd["device_ops"][0][0] == "k1" and bd["device_ops"][0][1] == pytest.approx(200e-6)
    assert bd["idle_gaps"][0] == ["host:ed25519.host_hash+port_bench.call", pytest.approx(600e-6)]
    idle = cells.reader(str(tiny.REPO), "device_idle_pct")(SimpleNamespace(device=t))
    assert idle == pytest.approx(65.0)


def test_the_control_comes_out_not_correct(root):
    for seed in (1, 2, 3):
        res, _ = _run(root, tiny.CELLS[0], seed=seed, build=control.Lax)
        assert not res["correct"]
        # two of the three bad classes pass the lax equation: one lane each a pool copy
        assert res["checks"]["mismatches"]["value"] == 2 * 2 * res["calls"]


def test_faults_of_the_timed_path_come_out_not_correct(root, monkeypatch):
    from stellar_tpu_torch.crypto.sigbackend import GpuSigBackend
    from stellar_tpu_torch.ops import ed25519 as ted
    from stellar_tpu_torch.ops import sha512 as tsha

    # an answer altered where it is produced: the first verdict of each chunk
    collect = ted.BatchVerifier._collect

    def altered(fut):
        out = collect(fut).copy()
        out[0] = not out[0]
        return out

    with monkeypatch.context() as m:
        m.setattr(ted.BatchVerifier, "_collect", staticmethod(altered))
        for cell in tiny.CELLS + (tiny.HOSTHASH,):
            res, _ = _run(root, cell)
            assert not res["correct"] and res["checks"]["mismatches"]["value"] >= 2 * res["calls"]

    # half of the batch left out: the second half answered with the first's verdicts
    verify_batch = GpuSigBackend.verify_batch

    def half(self, items, caller="close"):
        done = verify_batch(self, items[: len(items) // 2], caller)
        return done + done

    with monkeypatch.context() as m:
        m.setattr(GpuSigBackend, "verify_batch", half)
        res, _ = _run(root, tiny.HOSTHASH)
        assert not res["correct"] and res["checks"]["mismatches"]["value"] > 0

    # B2 left out: h is never computed on the card
    with monkeypatch.context() as m:
        m.setattr(tsha, "h_rows_from_packed", lambda p: p[96:128].clone())
        res, _ = _run(root, tiny.CELLS[0])
        assert not res["correct"]

    # a verdict list that never comes
    with monkeypatch.context() as m:
        m.setattr(GpuSigBackend, "verify_batch", lambda self, items, caller="close": [])
        res, _ = _run(root, tiny.HOSTHASH)
        assert not res["correct"] and res["checks"]["missing"]["value"] == res["attempted"]


def test_the_compared_calls_cover_every_call_order():
    mix = cells.find(str(tiny.REPO), tiny.CELLS[0]).mix
    every, n_orders = int(mix["keep_every"]), int(mix["orders"])
    # call c is compared where c % every is the seed's offset, and runs order
    # c % n_orders
    for offset in range(every):
        kept = [c for c in range(every * n_orders) if c % every == offset]
        assert {c % n_orders for c in kept} == set(range(n_orders))
