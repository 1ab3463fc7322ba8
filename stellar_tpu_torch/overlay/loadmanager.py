"""LoadManager — per-peer load attribution and shedding
(reference: src/overlay/LoadManager.{h,cpp}).

Heuristic blame assignment: while a peer's message is being processed, a
``PeerContext`` is on the stack; when it exits, the elapsed work time,
bytes moved, and SQL query count since entry are debited to that peer.
When the node's recent idle fraction drops below MINIMUM_IDLE_PERCENT,
``maybe_shed_excess_load`` drops the single worst-costed connected peer.
Costs live in an LRU so churn in low-cost peers can't grow the table.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

from ..util import xlog

log = xlog.logger("Overlay")

LRU_SIZE = 128


class PeerCosts:
    __slots__ = ("time_spent", "bytes_send", "bytes_recv", "sql_queries")

    def __init__(self):
        self.time_spent = 0.0
        self.bytes_send = 0
        self.bytes_recv = 0
        self.sql_queries = 0

    def is_less_than(self, other: "PeerCosts") -> bool:
        """Lexicographic by (time, send, recv, sql) — LoadManager.cpp
        PeerCosts::isLessThan."""
        mine = (self.time_spent, self.bytes_send, self.bytes_recv, self.sql_queries)
        theirs = (
            other.time_spent,
            other.bytes_send,
            other.bytes_recv,
            other.sql_queries,
        )
        return mine < theirs

    def to_json(self) -> dict:
        return {
            "time_spent_s": round(self.time_spent, 6),
            "bytes_send": self.bytes_send,
            "bytes_recv": self.bytes_recv,
            "sql_queries": self.sql_queries,
        }


class LoadManager:
    def __init__(self, app):
        self.app = app
        self._costs: OrderedDict[bytes, PeerCosts] = OrderedDict()
        self._shed_meter = app.metrics.new_meter(("overlay", "drop", "load-shed"), "drop")
        # receive-side shed decisions, read by the chaos scoreboard next
        # to the send-side (SendQueue) shed counters
        self.n_sheds = 0
        # recent-load window for the idle estimate
        self._window_start = time.monotonic()
        self._busy_seconds = 0.0

    def get_peer_costs(self, node_id: bytes) -> PeerCosts:
        pc = self._costs.get(node_id)
        if pc is None:
            pc = PeerCosts()
            self._costs[node_id] = pc
        self._costs.move_to_end(node_id)
        while len(self._costs) > LRU_SIZE:
            self._costs.popitem(last=False)
        return pc

    def report_loads(self) -> dict:
        """Diagnostic view for /peers &c (LoadManager::reportLoads)."""
        out = {}
        for node_id, pc in self._costs.items():
            out[node_id.hex()[:16]] = pc.to_json()
        return out

    # -- idle tracking ------------------------------------------------------
    def _note_busy(self, seconds: float) -> None:
        self._busy_seconds += seconds

    def _idle_percent(self) -> int:
        elapsed = time.monotonic() - self._window_start
        if elapsed <= 0:
            return 100
        busy = min(self._busy_seconds, elapsed)
        return int(100 * (1.0 - busy / elapsed))

    def _reset_window(self) -> None:
        self._window_start = time.monotonic()
        self._busy_seconds = 0.0

    def maybe_shed_excess_load(self) -> None:
        """Drop the worst-costed authenticated peer when idle time is
        below MINIMUM_IDLE_PERCENT (LoadManager::maybeShedExcessLoad)."""
        min_idle = self.app.config.MINIMUM_IDLE_PERCENT
        if min_idle <= 0:
            # keep the accounting window fresh while shedding is disabled,
            # or a later enable (via /ll or config reload) would judge idle
            # time over the entire process uptime and shed spuriously
            self._reset_window()
            return
        if self._idle_percent() >= min_idle:
            self._reset_window()
            return
        om = self.app.overlay_manager
        peers = [p for p in om.get_peers() if p.is_authenticated()]
        worst = None
        worst_costs = None
        for p in peers:
            pid = getattr(p, "peer_id", None)
            if pid is None:
                continue
            # peek only: inserting/promoting here would LRU-evict the very
            # cost records the scan is ranking
            pc = self._costs.get(bytes(pid.value))
            if pc is None:
                continue
            if worst_costs is None or worst_costs.is_less_than(pc):
                worst, worst_costs = p, pc
        if worst is not None:
            log.warning(
                "load shedding peer %s (idle %d%% < %d%%)",
                worst,
                self._idle_percent(),
                min_idle,
            )
            self._shed_meter.mark()
            self.n_sheds += 1
            worst.drop()
        self._reset_window()

    def peer_context(self, node_id: Optional[bytes]) -> "PeerContext":
        return PeerContext(self, node_id)


class PeerContext:
    """Stack context attributing work to a peer (LoadManager::PeerContext)."""

    def __init__(self, lm: LoadManager, node_id: Optional[bytes]):
        self.lm = lm
        self.node_id = node_id
        self._t0 = 0.0
        self._q0 = 0

    def __enter__(self):
        self._t0 = time.monotonic()
        self._q0 = getattr(self.lm.app.database, "query_count", 0)
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self._t0
        self.lm._note_busy(dt)
        if self.node_id is not None:
            pc = self.lm.get_peer_costs(self.node_id)
            pc.time_spent += dt
            pc.sql_queries += (
                getattr(self.lm.app.database, "query_count", 0) - self._q0
            )
        return False
