"""VirtualClock / VirtualTimer — the event-loop heart of the node.

Reference: src/util/Timer.{h,cpp} — VirtualClock owns the asio io_service
(docs/architecture.md:24-36); everything consensus/IO runs single-threaded on
it, with a worker pool for self-contained CPU (and here, TPU-dispatch) work.

This is our own loop (not asyncio): a deque of posted callbacks, a heap of
timers, a ``selectors`` poller for sockets, and a thread pool whose results
are posted back through a self-pipe — the same shape as asio.  Two modes:

- REAL_TIME:   ``now()`` is the wall clock; ``crank(block=True)`` sleeps in
               ``select`` until IO or the next timer.
- VIRTUAL_TIME: ``now()`` only moves when the loop is idle, jumping straight
               to the next timer deadline — the reference's deterministic-test
               superpower (SURVEY.md §2.12), kept intact.
"""

from __future__ import annotations

import heapq
import os
import selectors
import socket
import threading
import time as _time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

REAL_TIME = "real"
VIRTUAL_TIME = "virtual"


from . import globalchecks


class VirtualClock:
    def __init__(self, mode: str = VIRTUAL_TIME, num_workers: Optional[int] = None):
        assert mode in (REAL_TIME, VIRTUAL_TIME)
        self.mode = mode
        self._virtual_now = 0.0
        self._queue: deque = deque()  # posted callbacks
        self._timers: List = []  # heap of (deadline, seq, TimerEvent)
        self._seq = 0
        self._stopped = False
        self._selector = selectors.DefaultSelector()
        self._n_watched = 0
        # thread -> main-loop handoff (asio's post from worker threads)
        self._xqueue: deque = deque()
        self._xlock = threading.Lock()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, self._drain_wake)
        if num_workers is None:
            num_workers = os.cpu_count() or 2
        self._workers = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="stellar-worker"
        )
        # reactor thread affinity (GlobalChecks assertThreadIsMain)
        self._owner_tid = threading.get_ident()

    # -- time --------------------------------------------------------------
    def now(self) -> float:
        """Seconds.  Virtual mode: logical time; real mode: unix time."""
        if self.mode == VIRTUAL_TIME:
            return self._virtual_now
        return _time.time()

    def set_current_virtual_time(self, t: float) -> None:
        assert self.mode == VIRTUAL_TIME
        assert t >= self._virtual_now
        self._virtual_now = t

    # -- posting -----------------------------------------------------------
    def post(self, fn: Callable[[], None]) -> None:
        """Queue fn to run on the next crank (io_service::post).  Owner
        thread only (GlobalChecks.h assertThreadIsMain); workers use
        post_from_thread."""
        globalchecks.assert_thread_is(self._owner_tid)
        self._queue.append(fn)

    def post_from_thread(self, fn: Callable[[], None]) -> None:
        """Thread-safe post; wakes a blocking crank."""
        with self._xlock:
            self._xqueue.append(fn)
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass

    def submit_work(self, fn: Callable, on_done: Callable = None) -> None:
        """Run fn on the worker pool; post on_done(result_or_exception) back
        to the main loop (the reference's worker-thread pattern,
        ApplicationImpl.cpp:120)."""

        def run():
            try:
                res = fn()
            except Exception as e:  # delivered, not swallowed
                res = e
            if on_done is not None:
                self.post_from_thread(lambda: on_done(res))

        self._workers.submit(run)

    # -- sockets -----------------------------------------------------------
    def watch(self, sock, events: int, cb: Callable[[int], None]) -> None:
        """Register cb(events) for readable/writable; selectors.EVENT_*."""
        try:
            self._selector.modify(sock, events, cb)
        except KeyError:
            self._selector.register(sock, events, cb)
            self._n_watched += 1

    def unwatch(self, sock) -> None:
        try:
            self._selector.unregister(sock)
            self._n_watched -= 1
        except KeyError:
            pass

    # -- timers (used by VirtualTimer) -------------------------------------
    def _schedule(self, deadline: float, ev: "_TimerEvent") -> None:
        self._seq += 1
        heapq.heappush(self._timers, (deadline, self._seq, ev))

    def next_deadline(self) -> Optional[float]:
        while self._timers and self._timers[0][2].dead:
            heapq.heappop(self._timers)
        return self._timers[0][0] if self._timers else None

    def has_ready_work(self) -> bool:
        """True if a crank would process something WITHOUT leaping virtual
        time: posted callbacks, watched IO, or an already-due timer.  Lets
        test harnesses crank to quiescence instead of leaping into
        far-future deadlines (e.g. peers' 30s idle-drop timers)."""
        with self._xlock:
            if self._xqueue:
                return True
        if self._queue:
            return True
        # a watched-but-quiet socket is NOT ready work: probe with a
        # zero-timeout select (nothing is consumed by selecting)
        if self._n_watched > 0 and self._selector.select(0):
            return True
        nd = self.next_deadline()
        return nd is not None and nd <= self.now()

    # -- the crank ---------------------------------------------------------
    def crank(self, block: bool = False, max_block: Optional[float] = None) -> int:
        """Run one burst of ready work; returns number of events processed.

        Mirrors VirtualClock::crank (util/Timer.cpp): drain posted work, poll
        IO, fire due timers; in VIRTUAL mode, if idle, jump time to the next
        deadline and fire it.  Owner thread only (Timer.cpp calls
        assertThreadIsMain at its crank entry).
        """
        globalchecks.assert_thread_is(self._owner_tid)
        if self._stopped:
            return 0
        n = 0
        # cross-thread arrivals
        with self._xlock:
            while self._xqueue:
                self._queue.append(self._xqueue.popleft())
        # posted callbacks — snapshot to keep re-posting loops fair
        burst = len(self._queue)
        for _ in range(burst):
            cb = self._queue.popleft()
            cb()
            n += 1
        # IO poll (non-blocking)
        n += self._poll_io(0)
        # due timers
        n += self._fire_due_timers()
        if n == 0:
            if self.mode == VIRTUAL_TIME:
                # real sockets under virtual time: give in-flight IO a short
                # real-time window before leaping the clock, else timers
                # (ballot timeouts etc.) race ahead of kernel delivery
                if self._n_watched > 0:
                    n += self._poll_io(0.005)
                    if n:
                        return n
                nd = self.next_deadline()
                if nd is not None:
                    self._virtual_now = max(self._virtual_now, nd)
                    n += self._fire_due_timers()
            elif block:
                nd = self.next_deadline()
                timeout = None if nd is None else max(0.0, nd - self.now())
                if max_block is not None:
                    timeout = max_block if timeout is None else min(timeout, max_block)
                n += self._poll_io(timeout)
                n += self._fire_due_timers()
        return n

    def _poll_io(self, timeout) -> int:
        n = 0
        for key, events in self._selector.select(timeout):
            key.data(events)
            n += 1
        return n

    def _fire_due_timers(self) -> int:
        n = 0
        now = self.now()
        while self._timers:
            deadline, _, ev = self._timers[0]
            if ev.dead:
                heapq.heappop(self._timers)
                continue
            if deadline > now:
                break
            heapq.heappop(self._timers)
            ev.fire(cancelled=False)
            n += 1
        return n

    def _drain_wake(self, _events) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    # -- lifecycle ---------------------------------------------------------
    @property
    def stopped(self) -> bool:
        return self._stopped

    def stop(self) -> None:
        self._stopped = True

    def shutdown(self) -> None:
        self.stop()
        self._workers.shutdown(wait=True)
        try:
            self._selector.unregister(self._wake_r)
        except KeyError:
            pass
        self._wake_r.close()
        self._wake_w.close()
        self._selector.close()

    def crank_until(self, pred: Callable[[], bool], timeout: float) -> bool:
        """Crank until pred() or `timeout` seconds pass on THIS clock.
        (Simulation::crankUntil, simulation/Simulation.h:59)."""
        stop_at = self.now() + timeout
        while not pred():
            if self.now() > stop_at or self._stopped:
                return pred()
            blocking = self.mode == REAL_TIME
            cap = max(0.0, stop_at - self.now()) if blocking else None
            if self.crank(block=blocking, max_block=cap) == 0:
                if self.mode == VIRTUAL_TIME and self.next_deadline() is None:
                    return pred()  # fully idle, nothing will ever happen
        return True

    def crank_for(self, seconds: float) -> None:
        stop_at = self.now() + seconds
        self.crank_until(lambda: self.now() >= stop_at, seconds + 1)


class _TimerEvent:
    __slots__ = ("on_trigger", "on_cancel", "dead")

    def __init__(self, on_trigger, on_cancel):
        self.on_trigger = on_trigger
        self.on_cancel = on_cancel
        self.dead = False

    def fire(self, cancelled: bool) -> None:
        if self.dead:
            return
        self.dead = True
        if cancelled:
            if self.on_cancel is not None:
                self.on_cancel()
        elif self.on_trigger is not None:
            self.on_trigger()


class VirtualTimer:
    """asio deadline-timer twin (util/Timer.h:177): arm with expires_*, then
    async_wait(on_trigger, on_cancel); cancel() fires on_cancel handlers."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._deadline: Optional[float] = None
        self._events: List[_TimerEvent] = []

    @property
    def deadline(self) -> Optional[float]:
        return self._deadline

    def seconds_remaining(self) -> float:
        if self._deadline is None:
            return 0.0
        return max(0.0, self._deadline - self._clock.now())

    def expires_at(self, t: float) -> None:
        self.cancel()
        self._deadline = t

    def expires_from_now(self, seconds: float) -> None:
        self.cancel()
        self._deadline = self._clock.now() + seconds

    def async_wait(self, on_trigger: Callable[[], None],
                   on_cancel: Optional[Callable[[], None]] = None) -> None:
        if self._deadline is None:
            raise RuntimeError("timer not armed; call expires_* first")
        ev = _TimerEvent(on_trigger, on_cancel)
        self._events = [e for e in self._events if not e.dead]
        self._events.append(ev)
        self._clock._schedule(self._deadline, ev)

    def cancel(self) -> None:
        for ev in self._events:
            if not ev.dead:
                ev.fire(cancelled=True)
        self._events.clear()
        self._deadline = None
