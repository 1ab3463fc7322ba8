"""The port's span tracer (stellar_tpu_torch/trace/tracer.py): nesting and
cross-thread spans, ``record()`` of spans stamped elsewhere, and the
``py.gc`` spans of the collector's passes, which act on real clocks only.
"""

import gc
import threading
import time
import weakref
from types import SimpleNamespace

from stellar_tpu_torch.trace import NULL_TRACER, Tracer
from stellar_tpu_torch.trace import tracer as tracer_mod
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _virtual_clock(now=10.0):
    t = [now]
    return SimpleNamespace(mode="virtual", now=lambda: t[0]), t


def _gc_spans(tracer):
    return [s for s in tracer.spans() if s.name == "py.gc"]


def test_nested_spans_lie_inside_their_parent():
    tr = Tracer(ring_size=64)
    with tr.span("outer", k=1):
        with tr.span("inner"):
            time.sleep(0.001)
    spans = {s.name: s for s in tr.spans() if s.name != "py.gc"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer.start <= inner.start < inner.end <= outer.end
    assert outer.attrs == {"k": 1} and inner.attrs is None
    assert tr.aggregates()["outer"]["count"] == 1


def test_begin_and_end_on_different_threads():
    tr = Tracer(ring_size=64)
    sp = tr.begin("hop", side="caller")
    t = threading.Thread(target=lambda: tr.end(sp, side="worker"))
    t.start()
    t.join(10)
    assert not t.is_alive()
    (got,) = [s for s in tr.spans() if s.name == "hop"]
    assert got.end >= got.start and got.attrs == {"side": "worker"}
    assert got.tid == threading.get_ident()  # the thread that opened it
    tr.end(sp)  # a second end changes nothing
    assert len([s for s in tr.spans() if s.name == "hop"]) == 1


def test_record_on_a_real_clock():
    tr = Tracer(ring_size=64)
    a = time.monotonic()
    tr.record("stamped", a, a + 0.25, items=3)
    (sp,) = [s for s in tr.spans() if s.name == "stamped"]
    assert (sp.start, sp.end, sp.attrs) == (a, a + 0.25, {"items": 3})
    assert tr.aggregates()["stamped"]["max_ms"] == 250.0
    assert tr.real_clock


def test_record_does_nothing_on_a_virtual_clock_or_disabled():
    clock, _ = _virtual_clock()
    tr = Tracer(ring_size=64, clock=clock)
    assert not tr.real_clock
    tr.record("stamped", 1.0, 2.0)
    with tr.span("virtual"):
        pass
    assert [(s.name, s.start, s.end) for s in tr.spans()] == [("virtual", 10.0, 10.0)]
    NULL_TRACER.record("stamped", 1.0, 2.0)
    assert NULL_TRACER.spans() == []


def test_gc_spans_on_a_real_clock():
    tr = Tracer(ring_size=256)
    assert tr in tracer_mod._GC_TRACERS
    assert tracer_mod._gc_callback in gc.callbacks
    a = time.monotonic()
    gc.collect(1)
    gc.collect()
    b = time.monotonic()
    got = [s for s in _gc_spans(tr) if s.start >= a]
    assert {1, 2} <= {s.attrs["generation"] for s in got}
    assert all(a <= s.start <= s.end <= b for s in got)
    assert all(isinstance(s.attrs["collected"], int) for s in got)
    gc.collect(0)  # generation 0 is left out
    assert all(s.attrs["generation"] >= 1 for s in _gc_spans(tr))


def test_no_gc_spans_on_a_virtual_clock_or_disabled():
    clock, _ = _virtual_clock()
    virtual, off = Tracer(ring_size=64, clock=clock), Tracer(enabled=False)
    gc.collect()
    assert _gc_spans(virtual) == [] and _gc_spans(off) == []
    assert virtual not in tracer_mod._GC_TRACERS and off not in tracer_mod._GC_TRACERS


def test_gc_registration_is_weak():
    """The collector's callback keeps no tracer alive, and it is removed
    once no registered tracer is left."""
    tr = Tracer(ring_size=64)
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None
    live = list(tracer_mod._GC_TRACERS)
    assert (tracer_mod._gc_callback in gc.callbacks) == bool(live)


def test_collection_with_the_tracer_lock_held_does_not_deadlock():
    """A collection can start inside the tracer's locked section (an
    allocation in ``_complete``); the callback never waits on that lock,
    and the span lands with the next completion."""
    tr = Tracer(ring_size=64)
    done = threading.Event()

    def collect_under_lock():
        with tr._lock:
            gc.collect()
        done.set()

    t = threading.Thread(target=collect_under_lock, daemon=True)
    t.start()
    t.join(30)
    assert done.is_set() and not t.is_alive()
    with tr.span("after"):
        pass
    names = [s.name for s in tr.spans()]
    assert "py.gc" in names and "after" in names


def test_clear_drops_pending_gc_spans():
    tr = Tracer(ring_size=64)
    gc.collect()
    t = time.monotonic()
    tr.clear()
    assert all(s.start >= t for s in tr.spans()) and tr.dropped == 0
