"""The readers of the program's finer spans (host stage, pipeline, entry,
interpreter) and of the launch latency, on synthetic run contexts: each
reads nothing where its spans are missing, as at a commit whose program
records none, and the right mean or share where they are."""

import time
from types import SimpleNamespace

import pytest

from port_bench import cells, devtrace, run
from port_bench.tests import tiny

MEANS = {
    "stage_compute_ms": "ed25519.stage_compute",
    "stage_gil_wait_ms": "ed25519.stage_gil_wait",
    "stage_queue_ms": "ed25519.stage_queue",
    "drain_wait_ms": "ed25519.drain_wait",
    "drain_copy_ms": "ed25519.drain_copy",
}
NEW = tuple(MEANS) + ("stage_held_ms", "hop_ms", "gc_pct", "launch_latency_us")


def _read(name, **ctx):
    base = dict(spans=[], device=None, window_s=10.0)
    return cells.reader(str(tiny.REPO), name)(SimpleNamespace(**{**base, **ctx}))


def _calls(n, length=1.0):
    return [("port_bench.call", i * length, (i + 1) * length) for i in range(n)]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_spans(name):
    # a parent's traced run: the old spans and a device trace, none of the new
    old = [("ed25519.host_hash", 0.0, 0.009), ("ed25519.device_dispatch", 0.009, 0.010)]
    trace = devtrace.DeviceTrace(1.0, 0.5, [("Memcpy HtoD", 0.0095, 0.0096)], [(0.0, 0.0095)])
    assert _read(name) is None
    assert _read(name, spans=old + _calls(3), device=trace) is None


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_reads_the_new_spans_only_when_traced(tmp_path, trace):
    # no device trace on the CPU: launch_latency_us reads nothing; gc_pct
    # reads where a collection of generation 1 or 2 fell in the window
    root = tiny.make_root(tmp_path)
    res, _ = run.run_cell(str(root), tiny.CELLS[0], 2**31 + 7, 0.2, trace, device="cpu",
                          t0=time.monotonic())
    assert res["correct"] and res["failed"] == 0
    read = set(res["metrics"]) & set(NEW)
    spans = set(NEW) - {"gc_pct", "launch_latency_us"}
    assert read - {"gc_pct"} == (spans if trace else set())
    assert all(res["metrics"][name]["value"] > 0 for name in read)


def test_every_new_metric_is_listed_for_the_cell():
    cell = cells.find(str(tiny.REPO), tiny.CELLS[0])
    listed = {m["name"]: m for m in cell.per_layer}
    for name in NEW:
        assert listed[name]["moves"] == "verifies_per_s" and listed[name]["better"] == "lower"


@pytest.mark.parametrize("name,span", sorted(MEANS.items()))
def test_span_means(name, span):
    spans = [(span, 1.0, 1.002), (span, 2.0, 2.004), ("ed25519.drain", 0.0, 5.0)]
    assert _read(name, spans=spans + _calls(2)) == pytest.approx(3.0)


def test_stage_held_is_prologue_and_epilogue_a_stage_call():
    spans = [("ed25519.stage_prologue", 0.0, 0.001), ("ed25519.stage_compute", 0.001, 0.005),
             ("ed25519.stage_epilogue", 0.005, 0.0055),
             ("ed25519.stage_prologue", 1.0, 1.003), ("ed25519.stage_epilogue", 1.003, 1.0035)]
    assert _read("stage_held_ms", spans=spans) == pytest.approx(2.5)


def test_hops_are_summed_a_call():
    spans = [("sig.hop_out", 0.1, 0.1002), ("sig.hop_back", 0.9, 0.9004),
             ("sig.hop_out", 1.1, 1.1002)] + _calls(2)
    assert _read("hop_ms", spans=spans) == pytest.approx(0.4)


def test_gc_share_of_the_window_clipped_to_its_calls():
    spans = [("py.gc", 0.5, 0.6), ("py.gc", 3.9, 4.2), ("py.gc", -1.0, -0.5)] + _calls(4)
    assert _read("gc_pct", spans=spans, window_s=4.0) == pytest.approx(100 * 0.2 / 4.0)


def test_launch_latency_counts_launches_onto_an_idle_card_only():
    # three chunks: the card idle at the first and third launch, busy with
    # the first chunk's kernel when the second launches
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.0102, 0.0103), ("verify", 0.0103, 0.0200),
           ("Memcpy HtoD (Pinned -> Device)", 0.0200, 0.0201), ("verify", 0.0201, 0.0300),
           ("Memcpy HtoD (Pinned -> Device)", 0.0400, 0.0401), ("verify", 0.0401, 0.0500)]
    gaps = [(0.0, 0.0102), (0.0300, 0.0400), (0.0500, 0.0600)]
    trace = devtrace.DeviceTrace(0.06, 0.0298, ops, gaps)
    spans = [("ed25519.launch", 0.0100, 0.0104), ("ed25519.launch", 0.0150, 0.0152),
             ("ed25519.launch", 0.0396, 0.0398)]
    assert _read("launch_latency_us", spans=spans, device=trace) == pytest.approx(300.0)
    # a launch paired with no upload: nothing to read
    assert _read("launch_latency_us", spans=spans[:2], device=trace) is None
    # a launch whose upload began before it: below 0, as a clock offset shows
    one = devtrace.DeviceTrace(0.013, 0.0008, ops[:1] + [("verify", 0.0103, 0.0110)],
                               [(0.0, 0.0102), (0.0110, 0.0130)])
    late = [("ed25519.launch", 0.0120, 0.0121)]
    assert _read("launch_latency_us", spans=late, device=one) == pytest.approx(-1800.0)
