"""Dedicated background workers for level-spill bucket merges.

FutureBucket merges used to ride ``app.clock._workers`` — a pool sized
for *callback* work (history publish, herder timers) that owns exactly
one thread on small hosts, so a deep-level spill merge could queue
behind unrelated work and stall the close that needed to ``resolve()``
it.  This module gives merges their own threads, sized to the machine:
a merge starts the moment ``prepare`` fires and the close boundary that
commits it 4^level ledgers later finds it already done.

Semantics are untouched: the merge closure is the same one FutureBucket
always ran (same durable-write kill-points crossed, same error capture
into ``_done``/``_error``, resolved at the next close boundary), so
background and inline merging are bit-exact — pinned by
tests/test_hashplane.py's background-vs-inline differential and the
kill-point sweep.  ``Config.BACKGROUND_BUCKET_MERGE = False`` runs
every merge synchronously inside ``prepare`` instead (the differential
baseline, and a determinism crutch for single-stepped debugging).

Threads are daemonic and process-wide: merges are resumable across
process death by design (FutureBucket.make_live re-runs them from
hashes), so an exit mid-merge just leaves a reapable tmp file for the
boot sweep — the same contract a hard kill already has.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, List


class MergeWorkers:
    """A lazy, fixed-size pool draining merge closures from a queue."""

    def __init__(self, threads: int = 0):
        self._want = threads
        self._q: "queue.SimpleQueue[Callable[[], None]]" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []  # analysis: locked-by _lock
        self._started = False  # analysis: locked-by _lock

    def _size(self) -> int:
        if self._want > 0:
            return self._want
        # merges are C-heavy (native engine, GIL released): use the
        # cores, but leave headroom for the close loop itself
        return max(1, min(4, (os.cpu_count() or 1) - 1 or 1))

    def submit(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if not self._started:
                self._started = True
                for i in range(self._size()):
                    t = threading.Thread(
                        target=self._run,
                        name=f"bucket-merge-{i}",
                        daemon=True,
                    )
                    t.start()
                    self._threads.append(t)
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException:  # pragma: no cover — fn captures its own
                pass


# process-wide singleton: merges from every app instance share one pool
# (like the native pthread pool), bounded regardless of test app churn
_pool = MergeWorkers()


def submit(fn: Callable[[], None]) -> None:
    _pool.submit(fn)
