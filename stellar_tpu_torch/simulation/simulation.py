"""Simulation — N in-process validator Applications on one VirtualClock
(reference: src/simulation/Simulation.{h,cpp}).

The reference's answer to "how do you test a distributed system without a
cluster": every node is a full Application sharing a single virtual clock,
connected over LoopbackPeer pairs (or real TCP sockets on localhost), and
``crank_until`` advances the one clock until the predicate holds — fully
deterministic in VIRTUAL_TIME mode.

The chaos plane (stellar_tpu/scenarios/) drives the fault surface below:
``partition``/``heal`` sever and re-establish loopback links between node
groups, ``crash_node``/``restart_node`` take a validator down and bring it
back on its on-disk state, and ``ensure_links`` is the link doctor — in
loopback mode nothing reconnects by itself (there is no address book
dial-out), so lossy links that flap (any post-handshake drop/damage costs
the connection, see overlay/loopback.py FaultProfile) are re-established
here, carrying the scheduled fault profile onto the fresh pair.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..crypto.keys import SecretKey
from ..main.application import Application
from ..overlay import LoopbackPeerConnection, PeerRecord
from ..overlay.loopback import FaultProfile
from ..tx.testutils import get_test_config
from ..util import VIRTUAL_TIME, VirtualClock, xlog
from ..xdr.scp import SCPQuorumSet
from ..xdr.xtypes import PublicKey

log = xlog.logger("Overlay")

OVER_LOOPBACK = "loopback"
OVER_TCP = "tcp"


class Simulation:
    def __init__(self, mode: str = OVER_LOOPBACK, clock: Optional[VirtualClock] = None):
        assert mode in (OVER_LOOPBACK, OVER_TCP)
        self.mode = mode
        self.clock = clock or VirtualClock(VIRTUAL_TIME)
        self.nodes: Dict[bytes, Application] = {}  # pubkey raw -> app
        self.pending_connections: List[Tuple[bytes, bytes]] = []
        # live loopback pairs WITH their endpoints — one record per
        # connection so the fault surface can never misattribute a
        # profile or sever the wrong link
        self._live: List[Tuple[LoopbackPeerConnection, Tuple[bytes, bytes]]] = []
        # expected topology links (unordered pairs) — the link doctor's
        # target state; populated by add_connection/add_pending_connection
        self.links: List[Tuple[bytes, bytes]] = []
        # active partition: list of frozensets of node keys; links crossing
        # group boundaries stay severed until heal()
        self._partition_groups: List[frozenset] = []
        # active ONE-WAY partition: (src_set, dst_set) — frames src→dst
        # keep flowing, frames dst→src are silently dropped at the send
        # choke point (the half-open-connection case the symmetric groups
        # API cannot express; links stay up and authenticated)
        self._oneway: Optional[Tuple[frozenset, frozenset]] = None
        # per-link fault profile + deterministic reseed bookkeeping;
        # value = (profile, src) where src names the single sending node
        # the profile applies to (directional faults) or None for both
        self._link_profiles: Dict[frozenset, Tuple[FaultProfile, Optional[bytes]]] = {}
        # per-node clock-offset schedules (bytes key -> float | callable),
        # re-applied across restart_node so skew is a NODE property
        self._clock_offsets: Dict[bytes, object] = {}
        self._fault_seed = 0
        self._link_flaps: Dict[frozenset, int] = {}
        self._crashed: Dict[bytes, Tuple[SecretKey, object]] = {}
        self._next_instance = 0

    # -- building -----------------------------------------------------------
    def add_node(
        self,
        secret: SecretKey,
        qset: SCPQuorumSet,
        cfg=None,
        new_db: bool = True,
        force_scp: bool = True,
        validator: bool = True,
    ) -> Application:
        """force_scp=False models the reference's restart-without-FORCE_SCP
        (HerderTests.cpp "No Force SCP"): the node restores its last SCP
        statements from the DB and rebroadcasts, but does not start new
        rounds until it hears consensus.  validator=False builds a WATCHER:
        it evaluates its quorum set to follow consensus (and relays SCP
        traffic) but never nominates or votes — the committee-plus-relays
        shape the 100+ node scale scenario runs."""
        if cfg is None:
            cfg = get_test_config(self._next_instance)
        self._next_instance += 1
        cfg.NODE_SEED = secret
        cfg.NODE_IS_VALIDATOR = validator
        cfg.QUORUM_SET = qset
        # a watcher cannot bootstrap consensus (Herder.bootstrap asserts
        # a validator); it joins by hearing the committee externalize
        cfg.FORCE_SCP = force_scp and validator
        cfg.MANUAL_CLOSE = False
        cfg.RUN_STANDALONE = self.mode == OVER_LOOPBACK
        cfg.HTTP_PORT = 0
        app = Application.create(self.clock, cfg, new_db=new_db)
        self.nodes[secret.public_raw] = app
        # skew is a NODE property: a restarted validator keeps its bad
        # clock (the ops reality — rebooting does not fix a wrong RTC)
        off = self._clock_offsets.get(secret.public_raw)
        if off is not None:
            app.clock_offset_fn = self._as_offset_fn(off)
        return app

    def get_node(self, key) -> Application:
        raw = self._raw_key(key)
        return self.nodes[raw]

    @staticmethod
    def _raw_key(key) -> bytes:
        if isinstance(key, SecretKey):
            return key.public_raw
        if isinstance(key, PublicKey):
            return key.value
        return key

    def add_pending_connection(self, a, b) -> None:
        self.pending_connections.append((self._raw_key(a), self._raw_key(b)))

    def _note_link(self, ia: bytes, ib: bytes) -> None:
        if (ia, ib) not in self.links and (ib, ia) not in self.links:
            self.links.append((ia, ib))

    def add_connection(self, a, b) -> None:
        """Connect two running nodes now."""
        ia, ib = self._raw_key(a), self._raw_key(b)
        self._note_link(ia, ib)
        if self.mode == OVER_LOOPBACK:
            conn = LoopbackPeerConnection(self.nodes[ia], self.nodes[ib])
            self._live.append((conn, (ia, ib)))
            entry = self._link_profiles.get(frozenset((ia, ib)))
            if entry is not None:
                self._arm_profile(conn, ia, ib, entry)
            self._apply_oneway_to(conn, ia, ib)
        else:
            target = self.nodes[ib]
            self.nodes[ia].overlay_manager.connect_to(
                PeerRecord("127.0.0.1", target.config.PEER_PORT)
            )

    # -- lifecycle ----------------------------------------------------------
    def start_all_nodes(self) -> None:
        for app in self.nodes.values():
            app.start()
        for a, b in self.pending_connections:
            self.add_connection(a, b)
        self.pending_connections.clear()

    def stop_all_nodes(self) -> None:
        for app in self.nodes.values():
            app.graceful_stop()

    # -- chaos-plane fault surface (stellar_tpu/scenarios/) -----------------
    def set_fault_seed(self, seed: int) -> None:
        """Root seed for every fault-profile RNG this simulation arms —
        same topology + seed + fault program ⇒ identical fault rolls
        (the chaos plane's deterministic-replay contract)."""
        self._fault_seed = int(seed)

    def _arm_profile(
        self, conn: LoopbackPeerConnection, ia: bytes, ib: bytes,
        entry: Tuple[FaultProfile, Optional[bytes]],
    ) -> None:
        """Apply a fault profile to a live loopback pair, reseeding each
        side from (root seed, link identity, side, flap count) so re-runs
        roll identical faults and reconnects after a flap roll fresh-but-
        deterministic sequences.  ``entry`` = (profile, src): src None
        applies the profile to BOTH senders; otherwise only the peer
        owned by ``src`` (the one-way profile — frames src→peer ride the
        faults, the reverse sender stays clean)."""
        from ..crypto import sha256

        profile, src = entry
        link = frozenset((ia, ib))
        flap = self._link_flaps.get(link, 0)
        # stable digest, NOT hash(): bytes hashing is salted per process
        # (PYTHONHASHSEED) and the replay contract is cross-process
        base = int.from_bytes(
            sha256(
                self._fault_seed.to_bytes(8, "big", signed=True)
                + min(ia, ib)
                + max(ia, ib)
                + flap.to_bytes(4, "big")
            )[:8],
            "big",
        )
        clean = FaultProfile()
        # conn.initiator is owned by (and sends FROM) node ia; acceptor
        # sends from ib — the directional profile arms exactly one side
        init_prof = profile if src is None or src == ia else clean
        acc_prof = profile if src is None or src == ib else clean
        init_prof.apply(conn.initiator, seed=base ^ 0x5EED0001)
        acc_prof.apply(conn.acceptor, seed=base ^ 0x5EED0002)

    def set_link_faults(
        self, profile: FaultProfile, a=None, b=None, direction: str = "both"
    ) -> None:
        """Install `profile` on the link (a, b), or on EVERY link when both
        are None; live connections are armed now, reconnections (doctor,
        heal) re-arm automatically.  ``direction`` picks the sender the
        profile applies to: "both" (default), or "a-to-b"/"b-to-a" for the
        ONE-WAY profile — only frames flowing that way ride the faults,
        the reverse sender stays clean (requires explicit a and b)."""
        assert self.mode == OVER_LOOPBACK, "fault knobs ride loopback pairs"
        assert direction in ("both", "a-to-b", "b-to-a")
        if a is None and b is None:
            assert direction == "both", "one-way profiles need an explicit link"
            targets = [frozenset(l) for l in self.links]
            src = None
        else:
            ra, rb = self._raw_key(a), self._raw_key(b)
            targets = [frozenset((ra, rb))]
            src = {"both": None, "a-to-b": ra, "b-to-a": rb}[direction]
        for link in targets:
            self._link_profiles[link] = (profile, src)
        for conn, (ia, ib) in self._live:
            if frozenset((ia, ib)) in self._link_profiles and not (
                conn.initiator._closed and conn.acceptor._closed
            ):
                self._arm_profile(
                    conn, ia, ib, self._link_profiles[frozenset((ia, ib))]
                )

    def _sever_connection(self, conn: LoopbackPeerConnection) -> None:
        for peer in (conn.initiator, conn.acceptor):
            if not peer._closed:
                peer.drop()

    def link_is_up(self, a, b) -> bool:
        ia, ib = self._raw_key(a), self._raw_key(b)
        for conn, (ca, cb) in self._live:
            if {ca, cb} == {ia, ib} and (
                conn.initiator.is_authenticated()
                and conn.acceptor.is_authenticated()
            ):
                return True
        return False

    def _crosses_partition(self, ia: bytes, ib: bytes) -> bool:
        for g in self._partition_groups:
            if (ia in g) != (ib in g):
                return True
        return False

    def partition(self, *groups, oneway: bool = False) -> None:
        """Sever every link crossing the given node groups (each group a
        list of keys); the split stays enforced (the doctor will not
        re-establish crossing links) until ``heal``.

        ``oneway=True`` (exactly two groups) is the ASYMMETRIC split the
        symmetric API cannot express: frames group0→group1 keep flowing,
        frames group1→group0 are silently dropped at the send choke
        point — BEFORE a MAC sequence number is consumed, so the links
        stay up and authenticated (the real half-open-connection shape:
        one direction dead, the reverse still delivering with valid
        MACs), and ``heal`` resumes the dropped direction on the SAME
        connection with the sequence intact — no flap."""
        if oneway:
            assert self.mode == OVER_LOOPBACK, (
                "one-way splits arm blackholes on loopback pairs — an"
                " OVER_TCP sim would silently keep delivering"
            )
            assert len(groups) == 2, "one-way split takes exactly two groups"
            self._oneway = (
                frozenset(self._raw_key(k) for k in groups[0]),
                frozenset(self._raw_key(k) for k in groups[1]),
            )
            for conn, (ia, ib) in self._live:
                self._apply_oneway_to(conn, ia, ib)
            return
        self._partition_groups = [
            frozenset(self._raw_key(k) for k in g) for g in groups
        ]
        for conn, (ia, ib) in self._live:
            if self._crosses_partition(ia, ib):
                self._sever_connection(conn)

    def _apply_oneway_to(
        self, conn: LoopbackPeerConnection, ia: bytes, ib: bytes
    ) -> None:
        """Arm/clear the outbound blackholes a one-way partition implies
        on one live pair (idempotent; also clears when no split is up).
        The dropped direction is group1→group0: blackhole the peer whose
        OWNER is in group1 and whose remote is in group0."""
        if self._oneway is None:
            conn.initiator.outbound_blackhole = False
            conn.acceptor.outbound_blackhole = False
            return
        src_ok, dst = self._oneway
        # initiator sends ia→ib, acceptor sends ib→ia
        conn.initiator.outbound_blackhole = ia in dst and ib in src_ok
        conn.acceptor.outbound_blackhole = ib in dst and ia in src_ok

    def heal(self) -> None:
        """Lift the partition (symmetric AND one-way) and re-establish /
        resume the severed or silenced links now."""
        self._partition_groups = []
        if self._oneway is not None:
            self._oneway = None
            for conn, (ia, ib) in self._live:
                self._apply_oneway_to(conn, ia, ib)
        self.ensure_links()

    # -- per-node clocks ----------------------------------------------------
    @staticmethod
    def _as_offset_fn(offset):
        """Normalize a skew spec (constant seconds or callable(now) ->
        seconds) to the Application.clock_offset_fn shape."""
        if callable(offset):
            return offset
        const = float(offset)
        return lambda _now: const

    def set_clock_offset(self, key, offset) -> None:
        """Per-node clock-skew seam: shift ``key``'s WALL-time
        view (Application.time_now — closeTime nomination and the
        MAX_TIME_SLIP_SECONDS gate) by ``offset`` seconds — a constant, or
        a callable(shared_clock_now) -> seconds for drift/step schedules
        (scenarios/faults.py ClockSkew).  Deterministic: schedules are
        pure functions of the shared virtual clock.  Survives
        restart_node — a rebooted validator keeps its bad clock."""
        raw = self._raw_key(key)
        self._clock_offsets[raw] = offset
        app = self.nodes.get(raw)
        if app is not None:
            app.clock_offset_fn = self._as_offset_fn(offset)

    def clear_clock_offset(self, key) -> None:
        """Heal ``key``'s clock back to the shared truth (NTP fixed it)."""
        raw = self._raw_key(key)
        self._clock_offsets.pop(raw, None)
        app = self.nodes.get(raw)
        if app is not None:
            app.clock_offset_fn = None

    def ensure_links(self) -> None:
        """The link doctor: re-establish every expected-topology link whose
        loopback pair is gone (flapped lossy link, healed partition,
        restarted validator), carrying the link's fault profile onto the
        fresh pair.  Links crossing an active partition stay down."""
        if self.mode != OVER_LOOPBACK:
            return
        # compact dead pairs first so link_is_up scans stay honest
        self._live = [
            (c, ends)
            for c, ends in self._live
            if not (c.initiator._closed or c.acceptor._closed)
        ]
        for ia, ib in self.links:
            if ia in self._crashed or ib in self._crashed:
                continue
            if ia not in self.nodes or ib not in self.nodes:
                continue
            if self._crosses_partition(ia, ib):
                continue
            if not any({ca, cb} == {ia, ib} for _, (ca, cb) in self._live):
                self._link_flaps[frozenset((ia, ib))] = (
                    self._link_flaps.get(frozenset((ia, ib)), 0) + 1
                )
                self.add_connection(ia, ib)

    def crash_node(self, key) -> None:
        """Take a validator down hard: stop its subsystems (timers armed on
        the shared clock are cancelled — a dead node must not fire closes
        against a closed DB) and sever its links.  The node's config
        (pointing at its on-disk DB) is kept for restart_node."""
        raw = self._raw_key(key)
        app = self.nodes.pop(raw)
        secret = app.config.NODE_SEED
        for conn, (ia, ib) in self._live:
            if raw in (ia, ib):
                self._sever_connection(conn)
        app.graceful_stop()
        self._crashed[raw] = (secret, app.config)
        log.info("chaos: crashed node %s", raw.hex()[:8])

    def kill_node(self, key) -> None:
        """The NON-graceful crash: reap a node whose 'process' just died
        (a SimulatedProcessKill unwound its in-flight work — any open
        SQL transaction already rolled back through the context
        managers, exactly what a restart would observe).  Timers are
        cancelled because a dead process's timers cease to exist; the
        DB connection is abandoned (marked closed, no clean shutdown),
        and NOTHING is persisted on the way down — the difference from
        crash_node's graceful_stop."""
        raw = self._raw_key(key)
        app = self.nodes.pop(raw)
        secret = app.config.NODE_SEED
        for conn, (ia, ib) in self._live:
            if raw in (ia, ib):
                self._sever_connection(conn)
        # a dead process's timers vanish with it — cancel without any
        # state-persisting shutdown hooks
        if app.herder is not None:
            app.herder.shutdown()
        if app.overlay_manager is not None:
            app.overlay_manager.shutdown()
        if app.command_handler is not None:
            app.command_handler.stop()
        if app.process_manager is not None:
            app.process_manager.shutdown()
        app.database.closed = True
        try:
            app.database._conn.close()
        except Exception:
            pass
        self._crashed[raw] = (secret, app.config)
        log.info("chaos: hard-killed node %s", raw.hex()[:8])

    def _reap_simulated_kill(self, e) -> bool:
        """Map a SimulatedProcessKill's context (the dying node's
        Database) back to the node and reap it; True if a node died."""
        for raw, app in list(self.nodes.items()):
            if app.database is getattr(e, "ctx", None):
                self.kill_node(raw)
                return True
        return False

    def restart_node(self, key, force_scp: bool = True) -> Application:
        """Bring a crashed validator back on its on-disk state and rejoin
        it to the expected topology (the doctor re-links immediately)."""
        raw = self._raw_key(key)
        secret, cfg = self._crashed.pop(raw)
        cfg.FORCE_SCP = force_scp
        app = self.add_node(secret, cfg.QUORUM_SET, cfg=cfg, new_db=False,
                            force_scp=force_scp)
        app.start()
        self.ensure_links()
        log.info("chaos: restarted node %s", raw.hex()[:8])
        return app

    # -- cranking -----------------------------------------------------------
    # Every crank entry point rides out SimulatedProcessKill the same
    # way: an armed storage-fault injector (scenarios/storagefaults.py)
    # killing a node mid-crank reaps THAT node and cranking CONTINUES —
    # process death is a fault the rest of the network survives, not a
    # harness error.

    def crank_all_nodes(self, n: int = 1) -> int:
        from ..util.fs import SimulatedProcessKill

        total = 0
        for _ in range(n):
            try:
                total += self.clock.crank()
            except SimulatedProcessKill as e:
                if not self._reap_simulated_kill(e):
                    raise  # no live node owns this kill — harness bug
        return total

    def crank_until(self, pred: Callable[[], bool], timeout: float) -> bool:
        from ..util.fs import SimulatedProcessKill

        deadline = self.clock.now() + timeout
        while True:
            remaining = deadline - self.clock.now()
            if remaining <= 0:
                return pred()
            try:
                return self.clock.crank_until(pred, remaining)
            except SimulatedProcessKill as e:
                if not self._reap_simulated_kill(e):
                    raise  # no live node owns this kill — harness bug

    def crank_for_at_least(self, seconds: float) -> None:
        from ..util.fs import SimulatedProcessKill

        deadline = self.clock.now() + seconds
        while True:
            remaining = deadline - self.clock.now()
            if remaining <= 0:
                return
            try:
                self.clock.crank_for(remaining)
                return
            except SimulatedProcessKill as e:
                if not self._reap_simulated_kill(e):
                    raise  # no live node owns this kill — harness bug

    # -- predicates (Simulation.h:59-63) ------------------------------------
    def have_all_externalized(self, num_ledgers: int) -> bool:
        """True when every node's LCL has reached `num_ledgers`."""
        return all(
            app.ledger_manager.get_last_closed_ledger_num() >= num_ledgers
            for app in self.nodes.values()
        )

    def ledger_nums(self) -> List[int]:
        return [
            app.ledger_manager.get_last_closed_ledger_num()
            for app in self.nodes.values()
        ]

    def all_ledgers_agree(self) -> bool:
        """All nodes at the same LCL with the same hash (consensus check)."""
        lcls = [app.ledger_manager.last_closed for app in self.nodes.values()]
        if any(l is None for l in lcls):
            return False
        min_seq = min(l.header.ledgerSeq for l in lcls)
        # compare the chain at the lowest common sequence via stored headers
        hashes = set()
        for app in self.nodes.values():
            from ..ledger.headerframe import LedgerHeaderFrame

            f = LedgerHeaderFrame.load_by_sequence(app.database, min_seq)
            if f is None:
                return False
            hashes.add(f.get_hash())
        return len(hashes) == 1

    def dump_info(self) -> dict:
        return {
            "mode": self.mode,
            "nodes": {
                raw.hex()[:8]: {
                    "lcl": app.ledger_manager.get_last_closed_ledger_num(),
                    "peers": (
                        app.overlay_manager.get_authenticated_peer_count()
                        if app.overlay_manager
                        else 0
                    ),
                    "clock_offset": (
                        round(app.clock_offset_fn(self.clock.now()), 3)
                        if app.clock_offset_fn is not None
                        else 0
                    ),
                }
                for raw, app in self.nodes.items()
            },
        }
