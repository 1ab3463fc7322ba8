"""ProcessManager — async subprocess execution
(reference: src/process/ProcessManager{,Impl}.{h,cpp}).

``run_process(cmdline)`` is an async ``system()``: the command runs in a
real OS subprocess, a worker thread waits on it, and the exit status is
posted back to the main crank.  Concurrency is capped at
MAX_CONCURRENT_SUBPROCESSES (main/Config.h:146) with a pending queue —
history archival (curl / gzip / cp) is the main customer.
"""

from __future__ import annotations

import shlex
import subprocess
from collections import deque
from typing import Callable, Deque, Optional, Tuple

from ..util import xlog

log = xlog.logger("Process")


class ProcessExitEvent:
    """Handle for a queued/running subprocess; ``on_exit(returncode)`` fires
    on the main loop when it finishes (0 = success)."""

    __slots__ = ("cmdline", "on_exit", "out_file", "live", "returncode")

    def __init__(
        self,
        cmdline: str,
        on_exit: Optional[Callable[[int], None]],
        out_file: Optional[str] = None,
    ):
        self.cmdline = cmdline
        self.on_exit = on_exit
        self.out_file = out_file
        self.live = False
        self.returncode: Optional[int] = None


class ProcessManager:
    def __init__(self, app):
        self.app = app
        self.max_concurrent = app.config.MAX_CONCURRENT_SUBPROCESSES
        self.running = 0
        self.pending: Deque[ProcessExitEvent] = deque()
        self._live_procs = set()
        self._shutdown = False

    def run_process(
        self,
        cmdline: str,
        on_exit: Optional[Callable[[int], None]] = None,
        out_file: Optional[str] = None,
    ) -> ProcessExitEvent:
        """out_file redirects the child's stdout (the reference's
        runProcess(cmd, outFile) overload, ProcessManagerImpl — history
        archive `get` commands fetch into files this way)."""
        ev = ProcessExitEvent(cmdline, on_exit, out_file)
        self.pending.append(ev)
        self._maybe_start()
        return ev

    def get_num_running(self) -> int:
        return self.running

    def _maybe_start(self) -> None:
        while not self._shutdown and self.pending and self.running < self.max_concurrent:
            ev = self.pending.popleft()
            self._start(ev)

    def _start(self, ev: ProcessExitEvent) -> None:
        self.running += 1
        ev.live = True
        log.debug("running: %s", ev.cmdline)

        def work():
            if self._shutdown:
                return -15  # shutdown raced the spawn: never start the child
            out = subprocess.DEVNULL
            try:
                if ev.out_file is not None:
                    out = open(ev.out_file, "wb")
                proc = subprocess.Popen(
                    ev.cmdline,
                    shell=True,
                    stdout=out,
                    stderr=subprocess.DEVNULL,
                )
            except OSError as e:
                log.warning("spawn failed for %r: %s", ev.cmdline, e)
                return 127
            finally:
                # Popen dup'd the fd (or we never opened one); the parent's
                # handle can close either way
                if out is not subprocess.DEVNULL and not out.closed:
                    out.close()
            self._live_procs.add(proc)
            if self._shutdown:
                # shutdown() ran between the check above and the spawn —
                # it cannot have seen this proc in _live_procs, so kill here
                try:
                    proc.terminate()
                except OSError:
                    pass
            try:
                return proc.wait()
            finally:
                self._live_procs.discard(proc)

        def done(result):
            self.running -= 1
            ev.live = False
            ev.returncode = result if isinstance(result, int) else 1
            if ev.returncode != 0:
                log.debug("process exited %s: %s", ev.returncode, ev.cmdline)
            if ev.on_exit is not None:
                ev.on_exit(ev.returncode)
            self._maybe_start()

        self.app.clock.submit_work(work, done)

    def shutdown(self) -> None:
        """Kill live children so the worker threads joining them unblock
        (the reference ProcessManagerImpl kills on teardown)."""
        self._shutdown = True
        self.pending.clear()
        for proc in list(self._live_procs):
            try:
                proc.terminate()
            except OSError:
                pass
