"""Metrics registry (reference: lib/libmedida + per-subsystem NewMeter/NewTimer
call sites, SURVEY.md §5.5).

Same shapes as medida: Counter, Meter (count + EWMA 1/5/15min rates), Histogram
(reservoir percentiles), Timer (histogram-of-durations + meter).  Reported as
JSON with medida's field names so the admin ``/metrics`` endpoint looks like
the reference's (main/CommandHandler.cpp:82).

Metric names are dotted triples like ``scp.envelope.sign``.

Hot-path fast lane: registry-owned metrics record through a shared
append-only lane (``_FastLane``) instead of doing the reservoir/EWMA work per
call — close profiles bill the per-call wrapper work at
~0.35 s per 5000-tx close (8+ timer/meter updates per applied tx).  A record
is one tuple build + ``deque.append`` (both GIL-atomic, no lock); pending
samples drain into the real reservoir/EWMA state on any read (``to_json``,
``count``, percentiles), when the lane hits its size threshold, or at the
latest one EWMA tick (5 s) after the previous drain — so rates never
report a long-deferred burst as current activity.  Field names and JSON shape are unchanged; the
only observable difference is that EWMA tick timestamps are taken at drain
time instead of per-mark, which is within medida's own 5-second tick
granularity.  Metrics constructed WITHOUT a registry (``Timer()`` in tests,
standalone ``Histogram()``) keep the direct path.
"""

from __future__ import annotations

import math
import random
import threading
import time
from collections import deque
from typing import Dict, Optional


class _FastLane:
    """Shared hot-path sample buffer for one registry.

    ``record`` must stay lock-free: ``deque.append`` is atomic under the
    GIL, so concurrent recorders (main crank, sig-prewarm worker, trace
    spans completing on drain threads) never contend.  ``flush`` applies
    pending samples via each metric's ``_apply`` under a lock so two
    drains cannot interleave one metric's reservoir update; ``popleft``
    is likewise atomic, so a record racing a flush is either drained in
    this pass or stays queued — never lost."""

    __slots__ = ("_q", "_flush_lock", "_last_flush")

    # drain inline once this many samples are pending — bounds memory on a
    # node that is never asked for /metrics (threshold * tuple ≈ a few
    # hundred KB worst case, and the drain amortizes to ~1/8192 of calls)
    FLUSH_THRESHOLD = 8192
    # ...or once this much time has passed since the last drain: pending
    # marks must reach the EWMAs within one medida tick window, or a burst
    # deferred for minutes would be reported as CURRENT activity when a
    # reader finally drains it (rates would spike long after the fact).
    # The time check costs one monotonic() per record — still well under
    # the ≤~1 µs contract.
    FLUSH_SECONDS = 5.0  # = EWMA.TICK_SECONDS

    def __init__(self):
        self._q = deque()
        self._flush_lock = threading.Lock()
        self._last_flush = time.monotonic()

    def record(self, metric, value) -> None:
        q = self._q
        q.append((metric, value))
        if (
            len(q) >= self.FLUSH_THRESHOLD
            or time.monotonic() - self._last_flush >= self.FLUSH_SECONDS
        ):
            self.flush()

    def flush(self) -> None:
        self._last_flush = time.monotonic()
        q = self._q
        if not q:
            return
        with self._flush_lock:
            # group by metric first: a meter marked 5000x in one close then
            # pays ONE tick + EWMA update for the whole batch, and a
            # histogram pays one tight C-speed-ish loop — this is where the
            # per-call reservoir/EWMA work actually disappears, not just
            # moves (the samples are order-preserved within each metric, so
            # the reservoir state is bit-identical to the direct path)
            groups: Dict[int, list] = {}
            order = []
            while q:
                try:
                    m, v = q.popleft()
                except IndexError:  # racing flush drained the tail
                    break
                g = groups.get(id(m))
                if g is None:
                    groups[id(m)] = [v]
                    order.append(m)
                else:
                    g.append(v)
            for m in order:
                m._apply_batch(groups[id(m)])


class Counter:
    def __init__(self):
        self.count = 0

    def inc(self, n: int = 1):
        self.count += n

    def dec(self, n: int = 1):
        self.count -= n

    def set_count(self, n: int):
        self.count = n

    def to_json(self):
        return {"type": "counter", "count": self.count}


class EWMA:
    """Exponentially-weighted moving average rate, medida-style (5s ticks)."""

    TICK_SECONDS = 5.0

    def __init__(self, minutes: float, clock=None):
        self._alpha = 1.0 - math.exp(-self.TICK_SECONDS / 60.0 / minutes)
        self._uncounted = 0
        self._rate = 0.0
        self._initialized = False

    def update(self, n: int = 1):
        self._uncounted += n

    def tick(self):
        instant = self._uncounted / self.TICK_SECONDS
        self._uncounted = 0
        if self._initialized:
            self._rate += self._alpha * (instant - self._rate)
        else:
            self._rate = instant
            self._initialized = True

    @property
    def rate(self) -> float:
        return self._rate


class Meter:
    def __init__(self, event_type: str = "event", clock=None, lane=None):
        self.event_type = event_type
        self._count = 0
        self._clock = clock
        self._lane = lane
        self._start = self._now()
        self._last_tick = self._start
        self._m1 = EWMA(1)
        self._m5 = EWMA(5)
        self._m15 = EWMA(15)

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.monotonic()

    def mark(self, n: int = 1):
        lane = self._lane
        if lane is None:
            self._apply(n)
        else:
            lane.record(self, n)

    def _apply(self, n: int):
        self._tick_if_needed()
        self._count += n
        self._m1.update(n)
        self._m5.update(n)
        self._m15.update(n)

    def _apply_batch(self, ns):
        # EWMA.update only accumulates _uncounted, so one update with the
        # batch total is exactly n separate updates within one tick window
        self._apply(sum(ns))

    def _drain(self):
        if self._lane is not None:
            self._lane.flush()

    @property
    def count(self) -> int:
        self._drain()
        return self._count

    def _tick_if_needed(self):
        now = self._now()
        while now - self._last_tick >= EWMA.TICK_SECONDS:
            self._m1.tick()
            self._m5.tick()
            self._m15.tick()
            self._last_tick += EWMA.TICK_SECONDS

    @property
    def mean_rate(self) -> float:
        self._drain()
        elapsed = self._now() - self._start
        return self._count / elapsed if elapsed > 0 else 0.0

    @property
    def one_minute_rate(self) -> float:
        self._drain()
        self._tick_if_needed()
        return self._m1.rate

    def to_json(self):
        self._drain()
        self._tick_if_needed()
        return {
            "type": "meter",
            "count": self._count,
            "event_type": self.event_type,
            "mean_rate": self.mean_rate,
            "1_min_rate": self._m1.rate,
            "5_min_rate": self._m5.rate,
            "15_min_rate": self._m15.rate,
        }


class Histogram:
    """Uniform reservoir sample (medida's default), size 1028."""

    RESERVOIR = 1028

    def __init__(self, rng: Optional[random.Random] = None, lane=None):
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._sample = []
        self._rng = rng or random.Random(0x5EED)
        self._lane = lane

    def update(self, value: float):
        lane = self._lane
        if lane is None:
            self._apply(value)
        else:
            lane.record(self, value)

    def _apply(self, value: float):
        self._apply_batch((value,))

    def _apply_batch(self, vals):
        """One locals-bound loop over the batch — same per-value algorithm
        (and the same seeded rng call sequence) as the old per-call path,
        so the reservoir state is bit-identical; the dispatch overhead is
        paid once per flush instead of once per sample."""
        count = self._count
        total = self._sum
        mn, mx = self._min, self._max
        sample = self._sample
        append = sample.append
        randrange = self._rng.randrange
        res = self.RESERVOIR
        for v in vals:
            count += 1
            total += v
            if mn is None or v < mn:
                mn = v
            if mx is None or v > mx:
                mx = v
            if len(sample) < res:
                append(v)
            else:
                i = randrange(count)
                if i < res:
                    sample[i] = v
        self._count = count
        self._sum = total
        self._min, self._max = mn, mx

    def _drain(self):
        if self._lane is not None:
            self._lane.flush()

    @property
    def count(self) -> int:
        self._drain()
        return self._count

    def percentile(self, q: float) -> float:
        self._drain()
        if not self._sample:
            return 0.0
        s = sorted(self._sample)
        pos = q * (len(s) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    @property
    def mean(self) -> float:
        self._drain()
        return self._sum / self._count if self._count else 0.0

    @property
    def max_value(self) -> float:
        """Largest recorded value (exact, not reservoir-sampled) — the trace
        aggregator's max comes from here."""
        self._drain()
        return self._max if self._max is not None else 0.0

    def clear(self) -> None:
        """Reset the reservoir (medida Timer::Clear — the reference's
        auto-load calibration clears between adjustment periods).  Pending
        lane samples drain FIRST so a pre-clear record can never leak into
        the post-clear window."""
        self._drain()
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._sample.clear()

    def to_json(self):
        self._drain()
        return {
            "type": "histogram",
            "count": self._count,
            "min": self._min or 0.0,
            "max": self._max or 0.0,
            "mean": self.mean,
            "median": self.percentile(0.5),
            "75%": self.percentile(0.75),
            "95%": self.percentile(0.95),
            "98%": self.percentile(0.98),
            "99%": self.percentile(0.99),
            "99.9%": self.percentile(0.999),
        }


class Timer:
    """Duration metric; values recorded in milliseconds like medida."""

    def __init__(self, clock=None, lane=None):
        self._clock = clock
        self._lane = lane
        # the sub-metrics carry the SAME lane so direct reads of
        # timer.histogram.* / timer.meter.* (loadgen reads the mean,
        # clear() between calibration periods) drain pending timer
        # records first; Timer._apply feeds them via _apply/_apply_batch
        # directly, so one hot-path record never re-queues two more
        self.histogram = Histogram(lane=lane)
        self.meter = Meter("calls", clock, lane=lane)

    def update(self, seconds: float):
        lane = self._lane
        if lane is None:
            self._apply(seconds)
        else:
            lane.record(self, seconds)

    def _apply(self, seconds: float):
        self.histogram._apply(seconds * 1000.0)
        self.meter._apply(1)

    def _apply_batch(self, vals):
        self.histogram._apply_batch([s * 1000.0 for s in vals])
        self.meter._apply(len(vals))

    def _drain(self):
        if self._lane is not None:
            self._lane.flush()

    def time_scope(self) -> "TimeScope":
        return TimeScope(self)

    @property
    def count(self):
        self._drain()
        return self.histogram._count

    def to_json(self):
        self._drain()
        j = self.histogram.to_json()
        j.update(
            {
                "type": "timer",
                "duration_unit": "milliseconds",
                "rate_unit": "calls/s",
                "mean_rate": self.meter.mean_rate,
                "1_min_rate": self.meter.one_minute_rate,
            }
        )
        return j


class TimeScope:
    def __init__(self, timer: Timer):
        self._timer = timer
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.update(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Per-Application registry (main/Application.h:168)."""

    def __init__(self, clock=None):
        self._clock = clock
        self._metrics: Dict[str, object] = {}
        # tuple-parts -> metric: the hot apply path looks the same meters/
        # timers up ~8x per tx; this skips the join + isinstance + factory
        # allocation on every hit (0.6 s tottime per 10^6-scale close)
        self._by_parts: Dict[tuple, object] = {}
        # shared hot-path sample buffer for every metric this registry owns
        self._lane = _FastLane()

    def flush(self) -> None:
        """Drain pending fast-lane samples into the reservoir/EWMA state.
        Reads (to_json, counts, percentiles) call this themselves; expose
        it for callers that want the lane empty at a known point (tests,
        the bench harness between warmup and timed closes)."""
        self._lane.flush()

    def _get(self, parts, factory, want_type):
        # slow path only: the new_* accessors check the (tuple-parts, type)
        # memo inline BEFORE building the factory closure, so reaching
        # here with tuple parts means a guaranteed memo miss — no second
        # probe.  Keying on the type keeps the collision guard intact.
        memo_key = (parts, want_type) if isinstance(parts, tuple) else None
        name = self._name(parts)
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, want_type):
            # medida asserts on metric-type collisions; so do we
            raise TypeError(
                f"metric {name!r} is {type(m).__name__}, not {want_type.__name__}"
            )
        if memo_key is not None:
            self._by_parts[memo_key] = m
        return m

    @staticmethod
    def _name(parts) -> str:
        return ".".join(parts) if not isinstance(parts, str) else parts

    # the new_* accessors are on the per-op apply path (~3 calls/tx); on a
    # memo hit, return before allocating the factory closure _get takes —
    # the lambda alone costs more than the memo lookup

    def new_counter(self, parts) -> Counter:
        m = self._by_parts.get((parts, Counter)) if type(parts) is tuple else None
        return m if m is not None else self._get(parts, Counter, Counter)

    def new_meter(self, parts, event_type: str = "event") -> Meter:
        m = self._by_parts.get((parts, Meter)) if type(parts) is tuple else None
        if m is not None:
            return m
        return self._get(
            parts, lambda: Meter(event_type, self._clock, lane=self._lane), Meter
        )

    def new_histogram(self, parts) -> Histogram:
        m = self._by_parts.get((parts, Histogram)) if type(parts) is tuple else None
        if m is not None:
            return m
        return self._get(
            parts, lambda: Histogram(lane=self._lane), Histogram
        )

    def new_timer(self, parts) -> Timer:
        m = self._by_parts.get((parts, Timer)) if type(parts) is tuple else None
        if m is not None:
            return m
        return self._get(
            parts, lambda: Timer(self._clock, lane=self._lane), Timer
        )

    def get(self, parts):
        return self._metrics.get(self._name(parts))

    def to_json(self) -> dict:
        self._lane.flush()
        return {name: m.to_json() for name, m in sorted(self._metrics.items())}
