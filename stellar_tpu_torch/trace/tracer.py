"""Span tracer — structured phase profiling for the node's hot paths.

The reference attributes latency with libmedida timers embedded throughout
(SURVEY/PAPER.md layer 0); ``util/metrics.py`` reproduces the counting side
but cannot say *where inside a ledger close* the time went.  This module adds
the missing attribution plane:

- ``Tracer.span(name, **attrs)`` — context manager for synchronous phases;
  ``begin``/``end`` for phases that start and finish on different callbacks
  or threads (async prewarm joins, item fetches, SCP rounds).
- a lock-protected fixed-size ring buffer of completed spans (old spans are
  overwritten, the tracer never grows without bound);
- per-name latency aggregation: every completed span feeds a reservoir
  ``Histogram`` registered in the app's ``MetricsRegistry`` under
  ``trace.<name>``, so ``/metrics`` carries count/p50/p95/max for free;
- Chrome ``trace_event`` export (``chrome.py``) for ``/trace``.

Timestamps come from the owning ``Application``'s VirtualClock when that
clock runs in VIRTUAL mode — spans recorded under simulation tests are
bit-for-bit deterministic.  Real-time clocks (and no clock at all) fall back
to ``time.monotonic`` so wall-clock jumps can never produce negative
durations.

A disabled tracer (``Config.TRACE_ENABLED = false``) short-circuits to a
shared no-op scope before touching the ring or the clock; ``NULL_TRACER`` is
the module-wide disabled instance components use when no Application wired a
real one in (keeps every call site unconditional).

Two kinds of span act on real clocks only, since their stamps come from the
host's ``CLOCK_MONOTONIC`` (what ``time.monotonic`` reads on Linux) and a
virtual clock's spans must stay deterministic:

- ``Tracer.record(name, start, end, **attrs)`` takes a span whose stamps
  were taken elsewhere, e.g. by the C host stage (``native/sighash.c``);
  a tracer on a VIRTUAL clock records nothing through it;
- ``py.gc``: one span for each of the interpreter's collections of
  generation 1 or 2 (attributes ``generation`` and ``collected``), in every
  enabled tracer on the real clock, through one module-level
  ``gc.callbacks`` entry over a weak set of those tracers.  The entry is
  installed with the first such tracer and removed when the last one is
  collected, so it keeps no tracer alive.  Generation-0 passes are left out:
  they run every ~700 container allocations and would churn the ring.  A
  collection can start inside ``_complete``'s locked section (an
  allocation there), and the lock is not re-entrant, so the callback never
  takes it: it appends to the tracer's ``_gc_pending`` deque, which the
  next completion or read drains under the lock.
"""

from __future__ import annotations

import collections
import gc
import threading
import time
import weakref
from typing import Dict, List, Optional

from ..util.metrics import Histogram


class Span:
    """One completed (or in-flight) phase.  ``start``/``end`` are seconds on
    the tracer's clock; ``attrs`` land in the Chrome export's ``args``."""

    __slots__ = ("name", "start", "end", "tid", "attrs")

    def __init__(self, name: str, start: float, tid: int, attrs: Optional[dict]):
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.tid = tid
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __repr__(self) -> str:  # debugging aid only
        return f"Span({self.name!r}, {self.start:.6f}..{self.end}, {self.attrs})"


class _NoopScope:
    """Shared do-nothing context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_SCOPE = _NoopScope()


class _SpanScope:
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc):
        self._tracer.end(self._span)
        return False


class Tracer:
    """Per-Application span recorder (see module docstring)."""

    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = 8192,
        clock=None,
        metrics=None,
    ):
        self.enabled = bool(enabled)
        if ring_size < 1:
            raise ValueError("ring_size must be >= 1")
        self.ring_size = int(ring_size)
        self._ring: List[Optional[Span]] = [None] * self.ring_size
        self._idx = 0  # total completed spans ever (ring cursor = idx % size)
        self._dropped = 0
        self._lock = threading.Lock()
        self._metrics = metrics
        self._hists: Dict[str, Histogram] = {}
        # deterministic-test clock: only a VIRTUAL clock's now() is used
        # directly; REAL mode falls back to time.monotonic (wall time can
        # step backwards across NTP slews — a trace must not)
        if clock is not None and getattr(clock, "mode", None) == "virtual":
            self._now = clock.now
        else:
            self._now = time.monotonic
        # py.gc spans completed by the collector's callback, stored by the
        # next _complete or read (see the module docstring)
        self._gc_pending: collections.deque = collections.deque()
        if self.enabled and self.real_clock:
            _gc_register(self)

    @property
    def real_clock(self) -> bool:
        """True where the stamps are ``time.monotonic``'s (not a virtual
        clock's): ``record`` and ``py.gc`` act only then."""
        return self._now is time.monotonic

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing a synchronous phase."""
        if not self.enabled:
            return _NOOP_SCOPE
        return _SpanScope(
            self, Span(name, self._now(), threading.get_ident(), attrs or None)
        )

    def begin(self, name: str, **attrs) -> Optional[Span]:
        """Open a span explicitly (async phases; completes via ``end``).
        Returns None when disabled — ``end(None)`` is a no-op, so call
        sites never need their own enabled check."""
        if not self.enabled:
            return None
        return Span(name, self._now(), threading.get_ident(), attrs or None)

    def end(self, span: Optional[Span], **attrs) -> None:
        """Complete a span from ``begin`` (None-safe, double-end-safe)."""
        if span is None or span.end is not None:
            return
        span.end = self._now()
        if attrs:
            if span.attrs:
                span.attrs.update(attrs)
            else:
                span.attrs = attrs
        self._complete(span)

    def record(self, name: str, start: float, end: float, **attrs) -> None:
        """Record a completed span whose stamps (seconds of ``time.monotonic``,
        i.e. ``CLOCK_MONOTONIC``) were taken elsewhere.  Nothing is recorded
        by a disabled tracer or one on a virtual clock."""
        if not self.enabled or not self.real_clock:
            return
        span = Span(name, start, threading.get_ident(), attrs or None)
        span.end = end
        self._complete(span)

    def _complete(self, span: Span) -> None:
        with self._lock:
            self._store_locked(span)
            self._drain_gc_locked()

    def _store_locked(self, span: Span) -> None:
        if self._idx >= self.ring_size:
            self._dropped += 1
        self._ring[self._idx % self.ring_size] = span
        self._idx += 1
        hist = self._hists.get(span.name)
        if hist is None:
            hist = self._make_hist(span.name)
            self._hists[span.name] = hist
        hist.update(span.duration * 1000.0)

    def _drain_gc_locked(self) -> None:
        # a collection during the drain appends behind it: the loop takes
        # that span too
        pending = self._gc_pending
        while pending:
            self._store_locked(pending.popleft())

    def _make_hist(self, name: str) -> Histogram:
        if self._metrics is not None:
            # registered in the shared registry: /metrics reports the
            # trace.<name> aggregate with zero extra plumbing
            return self._metrics.new_histogram("trace." + name)
        return Histogram()

    # -- reading ------------------------------------------------------------
    def _spans_locked(self) -> List[Span]:
        self._drain_gc_locked()
        n = min(self._idx, self.ring_size)
        cursor = self._idx % self.ring_size
        if self._idx <= self.ring_size:
            return [s for s in self._ring[:n] if s is not None]
        return [
            s
            for s in self._ring[cursor:] + self._ring[:cursor]
            if s is not None
        ]

    def _aggregates_locked(self) -> Dict[str, dict]:
        self._drain_gc_locked()
        return {
            name: {
                "count": h.count,
                "p50_ms": h.percentile(0.5),
                "p95_ms": h.percentile(0.95),
                "max_ms": h.max_value,
            }
            for name, h in sorted(self._hists.items())
        }

    def _clear_locked(self) -> None:
        self._ring = [None] * self.ring_size
        self._idx = 0
        self._dropped = 0
        self._gc_pending.clear()
        for h in self._hists.values():
            h.clear()

    def spans(self) -> List[Span]:
        """Completed spans, oldest first (wraparound resolved)."""
        with self._lock:
            return self._spans_locked()

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wraparound since the last clear."""
        with self._lock:
            self._drain_gc_locked()
            return self._dropped

    def aggregates(self) -> Dict[str, dict]:
        """Per-name latency summary: count / p50 / p95 / max, milliseconds."""
        with self._lock:
            return self._aggregates_locked()

    def clear(self) -> None:
        """Drop recorded spans and aggregates (bench: reset after warmup).
        Registry-backed histograms are cleared in place so /metrics stays
        consistent with the ring."""
        with self._lock:
            self._clear_locked()

    def snapshot(self, clear: bool = False):
        """(spans, aggregates, dropped) under ONE lock hold — the /trace
        endpoint's dump-then-maybe-clear must not lose spans completed
        between a separate dump and clear."""
        with self._lock:
            out = (self._spans_locked(), self._aggregates_locked(), self._dropped)
            if clear:
                self._clear_locked()
        return out

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (load via chrome://tracing or
        https://ui.perfetto.dev)."""
        from .chrome import chrome_trace_json

        return chrome_trace_json(self.spans())


# -- py.gc: the collector's passes of generation 1 and 2 --------------------
_GC_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()
_gc_lock = threading.RLock()  # a finalizer may run inside a collection
_gc_open: List[Optional[float]] = [None]  # the start of the collection under way


def _gc_callback(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a ``py.gc`` span into every registered
    tracer's pending deque (never its lock; see the module docstring)."""
    gen = info.get("generation", 0)
    if gen < 1:
        return
    if phase == "start":
        _gc_open[0] = time.monotonic()
        return
    start, _gc_open[0] = _gc_open[0], None
    if start is None:
        return
    end = time.monotonic()
    tid = threading.get_ident()
    for tracer in list(_GC_TRACERS):
        if tracer.enabled:
            span = Span("py.gc", start, tid,
                        {"generation": gen, "collected": info.get("collected", 0)})
            span.end = end
            tracer._gc_pending.append(span)


def _gc_register(tracer: Tracer) -> None:
    with _gc_lock:
        _GC_TRACERS.add(tracer)
        if _gc_callback not in gc.callbacks:
            gc.callbacks.append(_gc_callback)
    weakref.finalize(tracer, _gc_forget).atexit = False


def _gc_forget() -> None:
    """A registered tracer was collected: remove the callback once no live
    one is left (the weak set yields live tracers only)."""
    with _gc_lock:
        if not any(True for _ in _GC_TRACERS) and _gc_callback in gc.callbacks:
            gc.callbacks.remove(_gc_callback)


# Disabled tracer for components constructed without an Application (ops-level
# BatchVerifier benchmarks, unit tests): every record call is a cheap no-op.
NULL_TRACER = Tracer(enabled=False, ring_size=1)


def tracer_of(app) -> Tracer:
    """The app's tracer, or NULL_TRACER for app-less/legacy callers."""
    t = getattr(app, "tracer", None)
    return t if t is not None else NULL_TRACER
