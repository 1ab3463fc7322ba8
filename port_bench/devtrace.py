"""The device trace of a run.

``Profiled`` runs ``torch.profiler`` (CPU and CUDA activity) around the
measured window, marks the window with a ``port_bench.window`` annotation,
exports the Chrome trace to a temporary file under ``TMPDIR``, reads it and
deletes it.  What it keeps is on the host's monotonic clock (the clock of
the program's span tracer), aligned by the annotation's start:

- ``ops``: each kernel, copy and memset on the card, clipped to the window;
- ``busy_s``: the union of their intervals; ``window_s``: the window;
- ``gaps``: the intervals of the window in which the card ran nothing.

``breakdown`` names the device operations that took most time and the
longest idle gaps by the program's host spans that were open in them.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import List, NamedTuple, Tuple

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace(NamedTuple):
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]   # (name, start, end), monotonic seconds
    gaps: List[Tuple[float, float]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and parameters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip()[:64] or name[:64]


def parse(events: list, mono0: float) -> DeviceTrace:
    """Chrome trace events -> the window's device trace; ``mono0`` is the
    monotonic time at which the window annotation opened."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the device trace holds no {WINDOW} annotation")
    t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    off = mono0 - t0 / 1e6
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e.get("dur", 0)), t1)
        if b > a:
            ops.append((e["name"], a / 1e6 + off, b / 1e6 + off))
    ops.sort(key=lambda o: o[1])
    busy, gaps = 0.0, []
    cur = t0 / 1e6 + off
    end = t1 / 1e6 + off
    for _, a, b in ops:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if end > cur:
        gaps.append((cur, end))
    return DeviceTrace((t1 - t0) / 1e6, busy, ops, gaps)


class Profiled:
    """``with Profiled() as p:`` around the window; ``p.trace`` after it."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(WINDOW)
        self.mono0 = time.monotonic()
        self._mark.__enter__()
        self.trace = None
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.trace = parse(events, self.mono0)
        return False


class SpanIndex:
    """The program's host spans, (name, start, end), to ask which were open
    at an instant."""

    def __init__(self, spans):
        self._spans = sorted(spans, key=lambda s: s[1])
        self._starts = [s[1] for s in self._spans]
        self._longest = max((b - a for _, a, b in self._spans), default=0.0)

    def label(self, t: float) -> str:
        names = set()
        j = bisect.bisect_right(self._starts, t) - 1
        while j >= 0 and self._starts[j] >= t - self._longest:
            n, a, b = self._spans[j]
            if b >= t:
                names.add(n)
            j -= 1
        return "host:" + ("+".join(sorted(names)) if names else "no program span")


def breakdown(trace: DeviceTrace, spans: SpanIndex, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the program spans open at its middle."""
    by_op = defaultdict(float)
    for name, a, b in trace.ops:
        by_op[short_name(name)] += b - a
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[n, s] for n, s in ops],
        "idle_gaps": [[spans.label((a + b) / 2), b - a] for a, b in gaps],
    }


def idle_by_span(trace: DeviceTrace, spans: SpanIndex) -> dict:
    """Idle seconds of the whole window, summed by the spans open in each
    gap (a wider view than the longest gaps)."""
    out = defaultdict(float)
    for a, b in trace.gaps:
        out[spans.label((a + b) / 2)] += b - a
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernel_seconds(trace: DeviceTrace, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(b - a for n, a, b in trace.ops if rx.search(n))
