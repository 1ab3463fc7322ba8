"""Storage fault injection — the deterministic kill-switch / torn-write
shim under the durable-write kill-point plane (util/fs.py).

Two hooks plug into ``fs.kill_point``:

- ``KillPointTrace`` — append-only record of every hit (flushed per
  line, because the process may die at any moment).  The kill-sweep's
  control run uses it to ENUMERATE the points a close+publish window
  actually crosses.
- ``StorageFaultInjector`` — fires ONCE at the ``nth`` hit of one named
  point, optionally corrupting the on-disk file first, then kills:

  * ``exit``      — ``os._exit(code)`` right at the point (the literal
                    hard-kill; no atexit, no finally, no flush)
  * ``truncate``  — truncate the file at the point to half, then exit
  * ``torn``      — truncate to half + append garbage (a torn partial
                    write: what an OS crash can leave of an unsynced
                    write), then exit
  * ``raise``     — raise ``fs.SimulatedProcessKill`` instead of
                    exiting: the in-process chaos matrix's hard kill
                    (Simulation.crank_until catches it and reaps the
                    node mid-close)

Determinism: the injector is a pure (point, nth, owner) counter — same
topology + seed + crank order ⇒ same firing moment, which is what lets
``hard_kill_mid_close`` pass the two-run replay gate.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..util import fs
from ..util.fs import SimulatedProcessKill  # noqa: F401  (re-export)

KILL_EXIT_CODE = 137  # what SIGKILL would report; the sweep asserts it

MODES = ("exit", "truncate", "torn", "raise")

# deterministic torn-tail garbage: recognizable in a hexdump, never a
# valid RFC 5531 record mark (high bit pattern is nonsense mid-stream)
TORN_GARBAGE = b"\xde\xad\xbe\xef" * 16


def corrupt_file(path: str, mode: str) -> None:
    """Apply the named corruption to an on-disk file (used by the
    injector at a ``:write`` stage, and directly by tests building
    corrupt artifacts)."""
    if not path or not os.path.exists(path):
        return
    size = os.path.getsize(path)
    keep = size // 2
    with open(path, "r+b") as f:
        f.truncate(keep)
        if mode == "torn":
            f.seek(keep)
            f.write(TORN_GARBAGE)
        f.flush()
        os.fsync(f.fileno())


class KillPointTrace:
    """fs hook: append one ``name\\tpath`` line per hit, flushed
    immediately (the process this traces is built to die mid-write)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def __call__(self, name: str, path: Optional[str], ctx) -> None:
        with self._lock:
            self._f.write("%s\t%s\n" % (name, path or ""))
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def read_points(path: str):
        """Ordered unique point names from a trace file."""
        seen = []
        have = set()
        with open(path) as f:
            for line in f:
                name = line.split("\t", 1)[0].strip()
                if name and name not in have:
                    have.add(name)
                    seen.append(name)
        return seen


class StorageFaultInjector:
    """fs hook: one deterministic fault at the nth hit of one point.

    ``owner`` scopes the counter to one node in a multi-node process
    (matched by identity against the kill-point's ``ctx`` — the node's
    Database object on every registered point that has one)."""

    def __init__(
        self,
        point: str,
        nth: int = 1,
        mode: str = "exit",
        owner=None,
        exit_code: int = KILL_EXIT_CODE,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (one of {MODES})")
        if nth < 1:
            raise ValueError("nth must be >= 1")
        self.point = point
        self.nth = nth
        self.mode = mode
        self.owner = owner
        self.exit_code = exit_code
        self.hits = 0
        self.fired = False

    def __call__(self, name: str, path: Optional[str], ctx) -> None:
        if name != self.point or self.fired:
            return
        if self.owner is not None and ctx is not self.owner:
            return
        self.hits += 1
        if self.hits != self.nth:
            return
        self.fired = True
        if self.mode in ("truncate", "torn"):
            corrupt_file(path, self.mode)
        if self.mode == "raise":
            raise SimulatedProcessKill(name, ctx)
        # the hard kill: no atexit, no finally, no buffered-IO flush —
        # the closest a Python process gets to SIGKILLing itself
        os._exit(self.exit_code)


def parse_arm_spec(spec: str) -> StorageFaultInjector:
    """``point[:nth[:mode]]`` — note the point name itself may contain a
    stage suffix like ``bucket.fresh:write``, so nth/mode are parsed
    from the RIGHT and must be an integer / a known mode."""
    parts = spec.split(":")
    nth, mode = 1, "exit"
    if parts and parts[-1] in MODES:
        mode = parts.pop()
    if parts and parts[-1].isdigit():
        nth = int(parts.pop())
    point = ":".join(parts)
    if not point.strip(":"):
        raise ValueError(f"bad kill spec {spec!r}")
    return StorageFaultInjector(point, nth=nth, mode=mode)


def install_from_env() -> list:
    """Arm hooks from the environment (the kill-sweep child's seam):

    - ``STELLAR_TPU_KILLPOINT_TRACE=<file>``  — record every hit
    - ``STELLAR_TPU_KILL_POINT=point[:nth[:mode]]`` — one injector

    Returns the installed hooks (caller removes them via
    ``fs.remove_kill_hook`` when its fault window closes)."""
    hooks = []
    trace = os.environ.get("STELLAR_TPU_KILLPOINT_TRACE")
    if trace:
        hooks.append(KillPointTrace(trace))
    spec = os.environ.get("STELLAR_TPU_KILL_POINT")
    if spec:
        hooks.append(parse_arm_spec(spec))
    for h in hooks:
        fs.add_kill_hook(h)
    return hooks
