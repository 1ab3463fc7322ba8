"""Fault programs — the scheduled adversities a scenario runs under.

Each fault is a declarative event (or event pair) with clock offsets; the
Scenario runner arms them on the simulation's clock at start.  Faults talk
only to the Simulation's chaos surface (partition/heal/crash_node/
restart_node/set_link_faults/ensure_links) and to the public node APIs the
reference's byzantine tests use (enqueue_scp_envelope, recv_transaction),
so a fault program composes with any topology.

Determinism: every fault that rolls randomness derives its RNG from the
scenario seed (never the module-level ``random``), and link-fault knobs
reseed the LoopbackPeer fault RNGs through the simulation's
``set_fault_seed`` plumbing — same topology + seed + program ⇒ identical
faults, identical scoreboard (the replay contract).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional

from ..overlay.loopback import FaultProfile
from ..util import VirtualTimer, xlog

log = xlog.logger("Scenario")


class Fault:
    """Base: subclasses implement ``arm(scn)`` — schedule whatever timers
    the fault needs on ``scn.sim.clock`` (offsets are seconds from the
    moment the fault program arms, i.e. after stabilization)."""

    def arm(self, scn) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    # shared helper: one-shot timer on the scenario clock.  ``slot`` names
    # a reusable timer on this fault — recurring ticks (flood cadence,
    # lag polls) re-arm ONE timer instead of allocating a fresh
    # VirtualTimer per tick (all of which the scenario would retain for
    # teardown cancellation).
    def _at(self, scn, delay: float, fn, slot: Optional[str] = None) -> None:
        if slot is None:
            t = VirtualTimer(scn.sim.clock)
            scn._fault_timers.append(t)
        else:
            slots = self.__dict__.setdefault("_timer_slots", {})
            t = slots.get(slot)
            if t is None:
                t = slots[slot] = VirtualTimer(scn.sim.clock)
                scn._fault_timers.append(t)
        t.expires_from_now(max(0.0, delay))
        t.async_wait(fn)

    # shared engage→heal scaffold for faults with a lag-polled heal
    # (Partition, ClockSkew, AsymmetricPartition): arm ``engage_fn`` at
    # ``at``; heal at the ``heal_at`` deadline or as soon as the fastest
    # node is ``heal_lag`` ledgers past the slowest — whichever first,
    # at most once.  ``heal_fn(reason)`` performs the class-specific
    # undo + note; the scaffold owns the once-only sentinel, the
    # recovery-clock stamp, and the poll rescheduling.
    def _arm_engage_heal(
        self, scn, engage_fn, heal_fn, *,
        at: float,
        heal_at: Optional[float] = None,
        heal_lag: Optional[int] = None,
        poll: float = 0.25,
    ) -> None:
        healed = []

        def heal(reason):
            if healed or scn.done:
                return
            healed.append(True)
            heal_fn(reason)
            scn.mark_recovery_start()

        def poll_lag():
            if healed or scn.done:
                return
            lcls = scn.sim.ledger_nums()
            if lcls and max(lcls) - min(lcls) >= heal_lag:
                heal("lag=%d" % (max(lcls) - min(lcls)))
            else:
                self._at(scn, poll, poll_lag, slot="poll")

        def engage():
            engage_fn()
            if heal_lag is not None:
                self._at(scn, poll, poll_lag, slot="poll")

        self._at(scn, at, engage)
        if heal_at is not None:
            self._at(scn, heal_at, lambda: heal("deadline"))


@dataclass
class Partition(Fault):
    """Split the topology into ``groups`` (lists of node indices) at ``at``;
    heal at ``heal_at`` (None = never — the scenario end heals).  The heal
    stamps the scoreboard's recovery clock.

    ``heal_lag`` (with ``heal_at`` as the backstop deadline) heals as soon
    as the fastest group has closed ``heal_lag`` ledgers past the slowest
    — the shape that pins a REPLAYABLE lag: ≤ the SCP state window
    (MAX_SLOTS_TO_REMEMBER), so the laggards replay the missed slots from
    peers' state as one pipelined close backlog instead of needing a
    history archive.  Leader-election stalls right after the split make a
    pure-time heal roll the dice on how much lag actually built; the
    lag-polled heal is deterministic about it."""

    at: float
    heal_at: Optional[float]
    groups: List[List[int]]
    heal_lag: Optional[int] = None
    poll: float = 0.25

    def arm(self, scn) -> None:
        def split():
            keys = [[scn.node_keys[i] for i in g] for g in self.groups]
            scn.sim.partition(*keys)
            scn.note("partition at t=%.1f: %s" % (scn.elapsed(), self.groups))

        def heal(reason):
            scn.sim.heal()
            scn.note("heal at t=%.1f (%s)" % (scn.elapsed(), reason))

        self._arm_engage_heal(
            scn, split, heal, at=self.at, heal_at=self.heal_at,
            heal_lag=self.heal_lag, poll=self.poll,
        )


@dataclass
class ClockSkew(Fault):
    """Per-node wall-clock skew: at ``at``, node ``node``'s
    ``Application.time_now`` view diverges from the shared clock through
    the Simulation's clock-offset seam — closeTime nomination and the
    MAX_TIME_SLIP_SECONDS acceptance gate see the skewed time, while
    every timer still rides the one shared clock.  Three schedules,
    composable and all pure functions of the shared virtual clock (the
    determinism contract — no wall reads, no RNG):

    - static:  ``offset`` seconds from the moment the fault engages;
    - drift:   ``drift_per_sec`` grows the offset linearly from engage
               (the cheap-oscillator shape);
    - step:    with ``step_at`` set, the static ``offset`` lands as a
               JUMP that many seconds after engage (the NTP-step shape;
               drift, if any, still accrues from engage).

    ``heal_at`` (deadline) / ``heal_lag`` (heal as soon as the fastest
    node is ``heal_lag`` ledgers past the slowest — the replayable-lag
    shape, like Partition) clear the offset and stamp the recovery
    clock.  A skew beyond MAX_TIME_SLIP_SECONDS makes the skewed node
    reject the quorum's values (metered as
    herder.value.reject-closetime-future) or the quorum reject the
    skewed node's — either way consensus must ride it out and the
    skewed node must rejoin once the skew heals."""

    at: float
    node: int
    offset: float = 0.0
    drift_per_sec: float = 0.0
    step_at: Optional[float] = None
    heal_at: Optional[float] = None
    heal_lag: Optional[int] = None
    poll: float = 0.25

    def arm(self, scn) -> None:
        key = scn.node_keys[self.node]

        def engage():
            t0 = scn.sim.clock.now()
            step_t = None if self.step_at is None else t0 + self.step_at
            static, drift = self.offset, self.drift_per_sec

            def offset_fn(now: float) -> float:
                off = drift * (now - t0)
                if step_t is None or now >= step_t:
                    off += static
                return off

            scn.sim.set_clock_offset(key, offset_fn)
            scn.note(
                "clock skew on node %d at t=%.1f: offset=%+.1fs"
                " drift=%+.3f/s step_at=%s"
                % (self.node, scn.elapsed(), static, drift, self.step_at)
            )

        def heal(reason):
            scn.sim.clear_clock_offset(key)
            scn.note(
                "clock skew on node %d healed at t=%.1f (%s)"
                % (self.node, scn.elapsed(), reason)
            )

        self._arm_engage_heal(
            scn, engage, heal, at=self.at, heal_at=self.heal_at,
            heal_lag=self.heal_lag, poll=self.poll,
        )


@dataclass
class AsymmetricPartition(Fault):
    """One-way isolation: at ``at``, frames TOWARD the
    ``deaf`` nodes are silently dropped while their own frames keep
    flowing — ``Simulation.partition(deaf, rest, oneway=True)``, the
    half-open-connection case.  Links stay up and authenticated the
    whole time (the drop happens before the MAC/sequence plane), so the
    deaf node keeps voting into a network it can no longer hear; heal
    resumes delivery on the SAME connections (no flap) and the deaf
    node replays the missed slots from peers' SCP state rebroadcast.
    ``heal_lag`` (with ``heal_at`` as deadline backstop) keeps the lag
    inside the replayable SCP window, like Partition."""

    at: float
    deaf: List[int]
    heal_at: Optional[float] = None
    heal_lag: Optional[int] = None
    poll: float = 0.25

    def arm(self, scn) -> None:
        deaf_keys = [scn.node_keys[i] for i in self.deaf]
        rest = [
            k for i, k in enumerate(scn.node_keys) if i not in self.deaf
        ]

        def split():
            # group0→group1 delivered, group1→group0 dropped: the deaf
            # nodes are heard (group0 = deaf) but hear nothing back
            scn.sim.partition(deaf_keys, rest, oneway=True)
            scn.note(
                "one-way partition at t=%.1f: nodes %s deaf"
                % (scn.elapsed(), self.deaf)
            )

        def heal(reason):
            scn.sim.heal()
            scn.note(
                "one-way partition healed at t=%.1f (%s)"
                % (scn.elapsed(), reason)
            )

        self._arm_engage_heal(
            scn, split, heal, at=self.at, heal_at=self.heal_at,
            heal_lag=self.heal_lag, poll=self.poll,
        )


@dataclass
class SlowLossyLinks(Fault):
    """Arm a lossy/latency FaultProfile on every link at ``at`` (and back
    to clean at ``heal_at``).  Post-handshake loss/damage flaps the
    connection (MAC-sequence break, overlay/loopback.py) — the scenario's
    link doctor re-establishes flapped pairs each tick, so what this
    models is a degraded, flapping network that consensus must ride out."""

    at: float
    heal_at: Optional[float] = None
    profile: FaultProfile = field(
        default_factory=lambda: FaultProfile(
            drop=0.02, duplicate=0.02, reorder=0.03, damage=0.01,
            latency=0.05,
        )
    )

    def arm(self, scn) -> None:
        def degrade():
            scn.sim.set_link_faults(self.profile)
            scn.note("links degraded at t=%.1f" % scn.elapsed())

        self._at(scn, self.at, degrade)
        if self.heal_at is not None:
            def restore():
                scn.sim.set_link_faults(FaultProfile())
                scn.sim.ensure_links()
                scn.mark_recovery_start()
                scn.note("links clean at t=%.1f" % scn.elapsed())

            self._at(scn, self.heal_at, restore)


@dataclass
class CrashRestart(Fault):
    """Take node ``node`` down hard at ``at``; bring it back on its
    on-disk state at ``restart_at`` (requires a disk-backed DATABASE,
    which the Scenario provisions for fault programs containing this).
    The restart stamps the recovery clock."""

    at: float
    restart_at: float
    node: int

    def arm(self, scn) -> None:
        key = scn.node_keys[self.node]

        def crash():
            scn.sim.crash_node(key)
            scn.note("crashed node %d at t=%.1f" % (self.node, scn.elapsed()))

        def restart():
            scn.sim.restart_node(key)
            scn.mark_recovery_start()
            scn.note("restarted node %d at t=%.1f" % (self.node, scn.elapsed()))

        self._at(scn, self.at, crash)
        self._at(scn, self.restart_at, restart)


@dataclass
class HardKillMidClose(Fault):
    """The storage plane's chaos class: a REAL kill, not
    ``graceful_stop``.  At ``at`` an in-process storage-fault injector
    (scenarios/storagefaults.py) arms on the target node's Database; the
    next time that node crosses the named durable-write kill-point —
    ``close.pre-commit`` by default: the whole close applied, bucket
    files written/renamed, header + LCL + publish-queue rows staged,
    COMMIT not yet run — a ``SimulatedProcessKill`` unwinds the node's
    entire in-flight close (the SQL transaction rolls back through the
    context managers, exactly what a restart observes) and
    ``Simulation.kill_node`` reaps it with NO graceful shutdown.  At
    ``restart_at`` the node comes back on its on-disk state; the boot
    self-check (main/selfcheck.py) must report ok/repaired before it
    rejoins.  Deterministic: (point, nth, owner) under the virtual
    clock's crank order — the class passes two-run replay."""

    at: float
    restart_at: float
    node: int
    point: str = "close.pre-commit"
    nth: int = 1

    def __post_init__(self):
        self.n_kills = 0
        self.selfcheck = None
        self._inj = None

    def arm(self, scn) -> None:
        from ..util import fs
        from .storagefaults import StorageFaultInjector

        key = scn.node_keys[self.node]

        def arm_injector():
            app = scn.sim.nodes.get(scn.sim._raw_key(key))
            if app is None:
                return
            inj = StorageFaultInjector(
                self.point, nth=self.nth, mode="raise",
                owner=app.database,
            )
            self._inj = inj
            fs.add_kill_hook(inj)
            scn.note(
                "armed hard-kill at %s (nth=%d) on node %d, t=%.1f"
                % (self.point, self.nth, self.node, scn.elapsed())
            )

        def restart():
            self.disarm()
            raw = scn.sim._raw_key(key)
            if raw not in scn.sim._crashed:
                scn.note(
                    "hard-kill never fired — node %d still alive at"
                    " restart deadline" % self.node
                )
                return
            self.n_kills += 1
            app = scn.sim.restart_node(key)
            self.selfcheck = app.last_selfcheck
            scn.mark_recovery_start()
            scn.note(
                "restarted hard-killed node %d at t=%.1f (selfcheck=%s)"
                % (
                    self.node,
                    scn.elapsed(),
                    (self.selfcheck or {}).get("status"),
                )
            )

        self._at(scn, self.at, arm_injector)
        self._at(scn, self.restart_at, restart)

    def disarm(self) -> None:
        from ..util import fs

        if self._inj is not None:
            fs.remove_kill_hook(self._inj)

    # Scenario.run verdict hook
    def verify_outcome(self, failures: List[str]) -> None:
        if self.n_kills < 1:
            failures.append(
                "hard_kill_mid_close: the kill-point injector never"
                " fired (no close crossed %s)" % self.point
            )
            return
        status = (self.selfcheck or {}).get("status")
        if status not in ("ok", "repaired"):
            failures.append(
                "hard_kill_mid_close: restarted node's boot self-check"
                " reported %r" % status
            )


@dataclass
class ByzantineFlood(Fault):
    """Invalid-signature envelope + transaction flood at volume, against
    ``target`` (node index), between ``at`` and ``until`` on a ``tick``
    cadence.  Envelopes ride the overlay's per-crank batch flush — the
    strict-gate fast-reject path under CALLER_OVERLAY — and reference
    made-up qset/txset hashes, so any regression of the eager reject
    would wedge the fetch plane (the scenario asserts it stays empty).
    Transactions carry garbage signatures through recv_transaction.

    The fault records every injected envelope's verify-cache key:
    ``assert_cache_unpolluted`` pins the no-latch-invalid contract
    after the run — extended to
    aggregate verdicts: storm keys may latch only True, never False.

    ``storm_per_tick`` adds the VALID-signature ballot storm (the
    expensive flood class: every envelope passes the strict gate and
    pays full curve math).  Storm envelopes are CONFIRM ballots from
    distinct ephemeral keys, pre-built and pre-signed at arm time (so
    injection never competes with the node for signing CPU), pinned to
    ``storm_slot`` — below the herder's slot bracket, so they exercise
    exactly the signature plane (the overlay flush verifies them; the
    herder drops them before the fetch/SCP planes) and land in ONE
    aggregation bucket per crank under SCP_SIG_SCHEME="ed25519-halfagg".
    They reference the target's real quorum-set hash: even a bracket
    straggler can never wedge the fetch plane."""

    at: float
    until: float
    target: int = 0
    # targeted flood: inject into EVERY node listed instead
    # of the single `target` — the tier-scoped flood shape (aim only at
    # tier-2 validators and assert tier-1's floor is undisturbed).  The
    # per-tick volumes apply PER TARGET.  None = [target].
    targets: Optional[List[int]] = None
    envelopes_per_tick: int = 25
    txs_per_tick: int = 5
    tick: float = 0.5
    storm_per_tick: int = 0
    storm_slot: int = 2
    # the storm signs from a FIXED byzantine committee (keys reused
    # across ticks, messages always distinct): realistic — an adversary
    # controls a validator set, not infinite fresh identities — and it
    # exercises the aggregate plane's validator-point cache the way a
    # real quorum does (A_i decode amortizes; only fresh R_i pay)
    storm_validators: int = 200

    def __post_init__(self):
        self.n_envelopes = 0
        self.n_txs = 0
        self.n_storm = 0
        self._cache_keys: List[bytes] = []
        self._storm_keys: List[bytes] = []
        self._storm_pool: List = []

    def arm(self, scn) -> None:
        self._rng = random.Random(scn.spec.seed ^ 0xF100D)
        if self.storm_per_tick:
            self._build_storm_pool(scn)
        self._at(scn, self.at, lambda: self._tick_fn(scn), slot='tick')

    def _build_storm_pool(self, scn) -> None:
        """Pre-sign the whole storm: one envelope per (tick, index) the
        window can consume, deterministic per scenario seed."""
        from ..crypto.keys import SecretKey, verify_cache
        from ..xdr.base import xdr_to_opaque
        from ..xdr.entries import EnvelopeType
        from ..xdr.scp import (
            SCPBallot,
            SCPEnvelope,
            SCPStatement,
            SCPStatementConfirm,
            SCPStatementPledges,
            SCPStatementType,
        )

        app = scn.sim.nodes[
            scn.sim._raw_key(scn.node_keys[self._target_indices()[0]])
        ]
        qset_hash = app.herder.scp.local_qset_hash
        n_ticks = int((self.until - self.at) / self.tick) + 2
        n = self.storm_per_tick * n_ticks * len(self._target_indices())
        base = 50_000_000 + (scn.spec.seed % 1000) * 100_000
        committee = [
            SecretKey.pseudo_random_for_testing(base + i)
            for i in range(self.storm_validators)
        ]
        for i in range(n):
            sk = committee[i % self.storm_validators]
            st = SCPStatement(
                nodeID=sk.get_public_key(),
                slotIndex=self.storm_slot,
                pledges=SCPStatementPledges(
                    SCPStatementType.SCP_ST_CONFIRM,
                    SCPStatementConfirm(
                        qset_hash,
                        1,
                        # NOT StellarValue-decodable: can never read as a
                        # txset dependency even off the bracket path
                        SCPBallot(1, b"storm %08d" % i),
                        1,
                    ),
                ),
            )
            payload = xdr_to_opaque(
                app.network_id, EnvelopeType.ENVELOPE_TYPE_SCP, st
            )
            env = SCPEnvelope(statement=st, signature=sk.sign(payload))
            self._storm_pool.append(env)
            self._storm_keys.append(
                verify_cache().key_for(
                    sk.public_raw, env.signature, payload
                )
            )

    def _target_indices(self) -> List[int]:
        return self.targets if self.targets is not None else [self.target]

    # -- injection ----------------------------------------------------------
    def _tick_fn(self, scn) -> None:
        if scn.elapsed_since_arm() >= self.until or scn.done:
            return
        for idx in self._target_indices():
            app = scn.sim.nodes.get(scn.sim._raw_key(scn.node_keys[idx]))
            if app is None:
                continue
            for _ in range(self.envelopes_per_tick):
                self._inject_envelope(app)
            for _ in range(self.txs_per_tick):
                self._inject_tx(app)
            for _ in range(self.storm_per_tick):
                if not self._storm_pool:
                    break
                app.overlay_manager.enqueue_scp_envelope(
                    self._storm_pool.pop()
                )
                self.n_storm += 1
        self._at(scn, self.tick, lambda: self._tick_fn(scn), slot='tick')

    def _forged_envelope(self, app):
        from ..crypto.keys import SecretKey
        from ..xdr.ledger import StellarValue
        from ..xdr.scp import (
            SCPEnvelope,
            SCPNomination,
            SCPStatement,
            SCPStatementPledges,
            SCPStatementType,
        )

        signer = SecretKey.pseudo_random_for_testing(
            30_000_000 + self._rng.randrange(1 << 30)
        )
        sv = StellarValue(
            txSetHash=self._rng.randbytes(32),
            closeTime=app.time_now() + 1,
            upgrades=[],
            ext=0,
        )
        nom = SCPNomination(
            quorumSetHash=self._rng.randbytes(32),
            votes=[sv.to_xdr()],
            accepted=[],
        )
        st = SCPStatement(
            nodeID=signer.get_public_key(),
            slotIndex=app.herder.next_consensus_ledger_index(),
            pledges=SCPStatementPledges(
                SCPStatementType.SCP_ST_NOMINATE, nom
            ),
        )
        return SCPEnvelope(statement=st, signature=self._rng.randbytes(64))

    def _inject_envelope(self, app) -> None:
        env = self._forged_envelope(app)
        pk, msg, sig = app.herder.envelope_verify_triple(env)
        from ..crypto.keys import verify_cache

        self._cache_keys.append(verify_cache().key_for(pk, sig, msg))
        app.overlay_manager.enqueue_scp_envelope(env)
        self.n_envelopes += 1

    def _inject_tx(self, app) -> None:
        from ..crypto.keys import SecretKey
        from ..tx import testutils as T
        from ..tx.frame import TransactionFrame
        from .. import xdr as X

        src = SecretKey.pseudo_random_for_testing(
            40_000_000 + self._rng.randrange(1 << 30)
        )
        dst = SecretKey.pseudo_random_for_testing(
            40_000_000 + self._rng.randrange(1 << 30)
        )
        tx = X.Transaction(
            sourceAccount=src.get_public_key(),
            fee=100,
            seqNum=self._rng.randrange(1, 1 << 40),
            timeBounds=None,
            memo=X.Memo.none(),
            operations=[T.payment_op(dst, 1)],
            ext=0,
        )
        frame = TransactionFrame(
            app.network_id, X.TransactionEnvelope(tx, [])
        )
        frame.add_signature(src)
        # corrupt the signature AFTER signing: a structurally-plausible
        # envelope whose sig fails strict verification
        sig = bytearray(frame.envelope.signatures[0].signature)
        sig[0] ^= 0xFF
        frame.envelope.signatures[0].signature = bytes(sig)
        app.herder.recv_transaction(frame)
        self.n_txs += 1

    # -- oracles -------------------------------------------------------------
    def assert_cache_unpolluted(self) -> int:
        """The shared verify cache must hold NO verdict for any flooded
        invalid-sig envelope (the no-latch-invalid / quarantine-under-
        flood contract) — and, for the valid-sig storm, no FALSE verdict
        either (an aggregate-accepted bucket latches True only; a False
        anywhere means some path broke the valid-only latch contract).
        Returns how many keys were checked."""
        from ..crypto.keys import verify_cache

        latched = [
            v for v in verify_cache().peek_many(self._cache_keys)
            if v is not None
        ]
        if latched:
            raise AssertionError(
                "%d/%d flooded invalid-sig envelopes latched a verdict in"
                " the shared verify cache" % (len(latched), len(self._cache_keys))
            )
        storm_false = [
            v for v in verify_cache().peek_many(self._storm_keys)
            if v is False
        ]
        if storm_false:
            raise AssertionError(
                "%d/%d storm envelopes latched a FALSE verdict — the"
                " valid-only latch contract broke on the aggregate path"
                % (len(storm_false), len(self._storm_keys))
            )
        return len(self._cache_keys) + len(self._storm_keys)


@dataclass
class IngestFlood(Fault):
    """Byzantine invalid-signature TRANSACTION flood through the verify-
    at-ingest front door, against ``target``'s admission
    plane, between ``at`` and ``until`` on a ``tick`` cadence — mixed
    with the spec's legitimate LoadGenerator stream at a multiple of its
    arrival rate.

    Every flooded tx is a structurally-plausible payment FROM THE
    EXISTING ROOT ACCOUNT whose signature is corrupted after signing:
    the root account hint-matches, so ``candidate_signature_pairs`` is
    non-empty and the admission plane's edge shed is the defense that
    must fire (metered ``ingest.reject.badsig``) — before check_valid,
    account loads, or flood fan-out spend anything.  (ByzantineFlood's
    tx flood uses NONEXISTENT accounts, which die in check_valid before
    any signature work; this class attacks the signature plane itself.)

    The fault records every corrupted triple's verify-cache key:
    ``assert_cache_unpolluted`` pins the valid-only latch contract at
    the admission plane — a flood of distinct invalid-sig txs latches
    NOTHING into the shared cache, so it can never evict honest entries
    from the bounded LRU."""

    at: float
    until: float
    target: int = 0
    txs_per_tick: int = 100
    tick: float = 0.25

    def __post_init__(self):
        self.n_txs = 0
        self._cache_keys: List[bytes] = []
        self._scn = None

    def arm(self, scn) -> None:
        self._scn = scn
        self._rng = random.Random(scn.spec.seed ^ 0x1609E57)
        self._at(scn, self.at, lambda: self._tick_fn(scn), slot='tick')

    def _tick_fn(self, scn) -> None:
        if scn.elapsed_since_arm() >= self.until or scn.done:
            return
        app = scn.sim.nodes.get(
            scn.sim._raw_key(scn.node_keys[self.target])
        )
        if app is not None and getattr(app, "ingest", None) is not None:
            for _ in range(self.txs_per_tick):
                self._inject_tx(app)
        self._at(scn, self.tick, lambda: self._tick_fn(scn), slot='tick')

    def _inject_tx(self, app) -> None:
        from ..crypto.keys import SecretKey, verify_cache
        from ..tx import testutils as T
        from ..tx.frame import TransactionFrame
        from .. import xdr as X

        root = T.root_key_for(app)
        dst = SecretKey.pseudo_random_for_testing(
            60_000_000 + self._rng.randrange(1 << 30)
        )
        tx = X.Transaction(
            sourceAccount=root.get_public_key(),
            fee=100,
            seqNum=self._rng.randrange(1, 1 << 40),
            timeBounds=None,
            memo=X.Memo.none(),
            operations=[T.payment_op(dst, 1)],
            ext=0,
        )
        frame = TransactionFrame(
            app.network_id, X.TransactionEnvelope(tx, [])
        )
        frame.add_signature(root)
        sig = bytearray(frame.envelope.signatures[0].signature)
        sig[0] ^= 0xFF
        frame.envelope.signatures[0].signature = bytes(sig)
        self._cache_keys.append(
            verify_cache().key_for(
                root.public_raw, bytes(sig), frame.get_contents_hash()
            )
        )
        app.ingest.submit(frame)
        self.n_txs += 1

    # -- oracles -------------------------------------------------------------
    def verify_outcome(self, failures: List[str]) -> None:
        """Every injected tx must have been shed at the ingest edge: the
        root source hint-matches, so the candidate triples are non-empty
        and all-invalid — a leak means signature work (or worse, a queue
        seat) was spent on provably-unauthorized traffic."""
        if self.n_txs == 0:
            failures.append("ingest_flood: no flood txs were injected")
            return
        planes = [
            app.ingest
            for app in self._scn.sim.nodes.values()
            if getattr(app, "ingest", None) is not None
        ]
        if not planes:
            failures.append("ingest_flood: no node built an IngestPlane")
            return
        for p in planes:
            # drain a final partial batch so every injected tx is decided
            # (the scoreboard snapshot already closed; this only feeds
            # the exact-count oracle below)
            p.flush_now()
        shed = sum(p.m_reject_badsig.count for p in planes)
        if shed != self.n_txs:
            failures.append(
                "ingest_flood: %d invalid-sig txs injected but %d shed at"
                " the edge — the admission plane leaked or double-counted"
                % (self.n_txs, shed)
            )

    def assert_cache_unpolluted(self) -> int:
        """The shared verify cache must hold NO verdict for any flooded
        invalid-sig tx triple — the valid-only latch contract at the
        admission plane.  Returns how many keys were checked."""
        from ..crypto.keys import verify_cache

        latched = [
            v for v in verify_cache().peek_many(self._cache_keys)
            if v is not None
        ]
        if latched:
            raise AssertionError(
                "%d/%d flooded invalid-sig ingest txs latched a verdict"
                " in the shared verify cache — the valid-only latch"
                " contract broke at the admission plane"
                % (len(latched), len(self._cache_keys))
            )
        return len(self._cache_keys)


@dataclass
class SlowReader(Fault):
    """The overlay survival plane's defining adversary: one
    peer drains its links at a fraction of the offered rate — the
    crashed-but-connected / underpowered / hostile slow reader.  Every
    link touching node ``node`` gets a ``FaultProfile(drain=...)`` byte
    -rate cap at ``at`` (whole frames, in order, no flaps), so its
    NEIGHBORS' transports back up: their send queues shed FLOOD toward
    it, keep CRITICAL first, and — once the CRITICAL head-of-line age
    crosses STRAGGLER_STALL_MS — disconnect it with ERR_LOAD inside the
    stall budget.  The link doctor re-establishes the pair (profile
    carried over), so the cycle repeats for the whole window; the
    consensus floor is asserted over the OTHER nodes."""

    at: float
    node: int
    drain_bytes_per_sec: float = 4096.0
    heal_at: Optional[float] = None

    def arm(self, scn) -> None:
        key = scn.node_keys[self.node]
        raw = scn.sim._raw_key(key)
        links = [
            (ia, ib) for (ia, ib) in scn.sim.links if raw in (ia, ib)
        ]

        def degrade():
            for ia, ib in links:
                scn.sim.set_link_faults(
                    FaultProfile(drain=self.drain_bytes_per_sec), ia, ib
                )
            scn.note(
                "slow reader: node %d drains at %d B/s from t=%.1f"
                % (self.node, self.drain_bytes_per_sec, scn.elapsed())
            )

        self._at(scn, self.at, degrade)
        if self.heal_at is not None:
            def restore():
                for ia, ib in links:
                    scn.sim.set_link_faults(FaultProfile(), ia, ib)
                scn.sim.ensure_links()
                scn.mark_recovery_start()
                scn.note("slow reader healed at t=%.1f" % scn.elapsed())

            self._at(scn, self.heal_at, restore)


@dataclass
class OverloadStorm(Fault):
    """Saturating tx-broadcast overload: every link is
    drain-capped at ``drain_bytes_per_sec`` and node ``source`` floods
    distinct invalid-signature TRANSACTION messages at several times that
    capacity between ``at`` and ``until``.  Without per-peer send-side
    bounding this queues consensus traffic behind the flood and grows the
    write buffers without bound; with the survival plane on, FLOOD sheds
    (metered), CRITICAL jumps every queue, the per-peer byte high-water
    stays under OVERLAY_SENDQ_BYTES, and the liveness floor holds.  The
    storm pool is pre-built at arm time from the scenario seed
    (deterministic replay; injection never competes for signing CPU)."""

    at: float
    until: float
    source: int = 0
    msgs_per_tick: int = 30
    tick: float = 0.25
    drain_bytes_per_sec: float = 16384.0
    # targeted overload: cap only the links TOUCHING these
    # node indices instead of every link — the tier-scoped storm (tier-2
    # links saturate and shed; tier-1's core links stay clean, so its
    # consensus floor is the undisturbed one).  None = every link.
    drain_nodes: Optional[List[int]] = None

    def __post_init__(self):
        self.n_storm = 0
        self._pool: List = []

    def _capped_links(self, scn) -> Optional[List[tuple]]:
        if self.drain_nodes is None:
            return None
        raws = {scn.sim._raw_key(scn.node_keys[i]) for i in self.drain_nodes}
        return [
            (ia, ib) for (ia, ib) in scn.sim.links if raws & {ia, ib}
        ]

    def arm(self, scn) -> None:
        self._rng = random.Random(scn.spec.seed ^ 0x570A4)
        self._build_pool(scn)

        def degrade():
            links = self._capped_links(scn)
            profile = FaultProfile(drain=self.drain_bytes_per_sec)
            if links is None:
                scn.sim.set_link_faults(profile)
            else:
                for ia, ib in links:
                    scn.sim.set_link_faults(profile, ia, ib)
            scn.note(
                "overload storm: %s drain at %d B/s, %d tx/tick"
                % (
                    "all links"
                    if links is None
                    else "%d links @ nodes %s" % (len(links), self.drain_nodes),
                    self.drain_bytes_per_sec,
                    self.msgs_per_tick,
                )
            )
            self._tick_fn(scn)

        def restore():
            links = self._capped_links(scn)
            if links is None:
                scn.sim.set_link_faults(FaultProfile())
            else:
                for ia, ib in links:
                    scn.sim.set_link_faults(FaultProfile(), ia, ib)
            scn.sim.ensure_links()
            scn.note("overload storm over at t=%.1f" % scn.elapsed())

        self._at(scn, self.at, degrade)
        self._at(scn, self.until, restore)

    def _build_pool(self, scn) -> None:
        """Distinct structurally-valid transactions with corrupted
        signatures (receivers fast-reject at the strict gate), packed
        once each — the flood rides broadcast_message's pack-once
        fan-out, so the storm's cost lands on the SEND queues."""
        from ..crypto.keys import SecretKey
        from ..tx import testutils as T
        from ..tx.frame import TransactionFrame
        from .. import xdr as X

        app = scn.sim.nodes[scn.sim._raw_key(scn.node_keys[self.source])]
        n_ticks = int((self.until - self.at) / self.tick) + 2
        for i in range(self.msgs_per_tick * n_ticks):
            src = SecretKey.pseudo_random_for_testing(
                60_000_000 + self._rng.randrange(1 << 30)
            )
            dst = SecretKey.pseudo_random_for_testing(
                60_000_000 + self._rng.randrange(1 << 30)
            )
            tx = X.Transaction(
                sourceAccount=src.get_public_key(),
                fee=100,
                seqNum=self._rng.randrange(1, 1 << 40),
                timeBounds=None,
                memo=X.Memo.none(),
                operations=[T.payment_op(dst, 1)],
                ext=0,
            )
            frame = TransactionFrame(
                app.network_id, X.TransactionEnvelope(tx, [])
            )
            frame.add_signature(src)
            sig = bytearray(frame.envelope.signatures[0].signature)
            sig[0] ^= 0xFF
            frame.envelope.signatures[0].signature = bytes(sig)
            self._pool.append(frame.to_stellar_message())

    def _tick_fn(self, scn) -> None:
        if scn.elapsed_since_arm() >= self.until or scn.done:
            return
        app = scn.sim.nodes.get(
            scn.sim._raw_key(scn.node_keys[self.source])
        )
        if app is not None:
            for _ in range(self.msgs_per_tick):
                if not self._pool:
                    break
                app.overlay_manager.broadcast_message(self._pool.pop())
                self.n_storm += 1
        self._at(scn, self.tick, lambda: self._tick_fn(scn), slot='tick')


@dataclass
class PartitionUntilCheckpoint(Fault):
    """The catchup-under-load shape: partition ``lagger`` off at ``at``
    and heal only once the majority's LCL has crossed
    ``heal_after_ledger`` — far enough that the lagger's SCP gap exceeds
    MAX_SLOTS_TO_REMEMBER and it must catch up from the history archive
    while the network keeps closing under load."""

    at: float
    heal_after_ledger: int
    lagger: int
    poll: float = 0.5

    def arm(self, scn) -> None:
        lag_key = scn.node_keys[self.lagger]
        rest = [k for i, k in enumerate(scn.node_keys) if i != self.lagger]

        def split():
            scn.sim.partition(rest, [lag_key])
            scn.note("catchup-lag partition at t=%.1f" % scn.elapsed())
            self._at(scn, self.poll, poll, slot='poll')

        def poll():
            if scn.done:
                return
            majority = max(
                scn.sim.get_node(k).ledger_manager.get_last_closed_ledger_num()
                for k in rest
            )
            if majority >= self.heal_after_ledger:
                scn.sim.heal()
                scn.mark_recovery_start()
                scn.note(
                    "heal at t=%.1f (majority lcl=%d)"
                    % (scn.elapsed(), majority)
                )
            else:
                self._at(scn, self.poll, poll, slot='poll')

        self._at(scn, self.at, split)
