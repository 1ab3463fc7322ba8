"""Scenario — one declarative chaos run: topology × load × fault program
× liveness scoreboard.

The runner composes a multi-node Simulation (core mesh or core-and-tier
ring), streams LoadGenerator traffic through it, arms the fault program on
the shared clock, and cranks until the liveness target (or the timeout)
while tracking recovery from heals/restarts.  Every run:

- runs the invariant plane all-on (get_test_config default) and FAILS on
  any accepted-ledger violation;
- asserts the surviving nodes agree on the chain;
- emits one LivenessScoreboard, with a deterministic digest for
  VIRTUAL_TIME scenarios (same topology + seed + program ⇒ same digest —
  tests/test_scenarios.py pins the replay);
- enforces the spec's liveness floors (ledgers/sec, recovery ms).

Clock modes: chaos scenarios default to VIRTUAL_TIME (deterministic,
seeded).  Catchup-under-load runs REAL_TIME like the history suite — the
archive get/put commands are real subprocesses whose completion the
virtual clock would leap past.
"""

from __future__ import annotations

import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..simulation import LoadGenerator, Simulation, topologies
from ..simulation.simulation import OVER_LOOPBACK, OVER_TCP
from ..tx.testutils import get_test_config
from ..util import REAL_TIME, VIRTUAL_TIME, VirtualClock, VirtualTimer, xlog
from ..xdr.scp import SCPQuorumSet
from .faults import Fault
from .scoreboard import LivenessScoreboard, snapshot

log = xlog.logger("Scenario")

# scenario node instance numbers start high so tmp/bucket dirs never
# collide with the unit suites' get_test_config(0..n) apps
_INSTANCE_BASE = 9100

# slack on the straggler-disconnect window verdict: the stall timer
# fires at the CRITICAL head's deadline on the virtual clock, so the
# recorded stall age sits AT the budget; this absorbs crank granularity
_STALL_POLL_SLACK_MS = 250.0


@dataclass
class ScenarioSpec:
    name: str
    fault_class: str
    faults: List[Fault]
    n_nodes: int = 3
    threshold: Optional[int] = None  # None = BFT majority
    topology: str = "core"  # "core" | "core_and_tier"
    tier_n: int = 0
    # False = tier nodes are WATCHERS (track + relay, never nominate):
    # the committee-plus-relays shape the 100+ node scale scenario runs
    tier_validators: bool = True
    clock_mode: str = "virtual"  # "virtual" | "real"
    # transport: "loopback" (in-process pairs, full fault surface) or
    # "tcp" (real localhost sockets — the 100+ node scale shape;
    # link-level fault knobs are loopback-only, node-API faults
    # like floods still apply)
    overlay_mode: str = "loopback"
    seed: int = 1
    # SCP envelope signature scheme for every node (Config.SCP_SIG_SCHEME):
    # "ed25519" or "ed25519-halfagg" — the flood matrix runs the same
    # storm under both and compares scheme verify wall
    scp_sig_scheme: str = "ed25519"
    # signature backend for every node (Config.SIGNATURE_BACKEND): None
    # keeps the test default ("gpu", the device batch plane); "cpu" runs
    # libsodium.  gpu_cpu_cutover=0 forces every flush onto
    # the device path so a flood-scale batch can't ride the host ladder.
    # sig_device (Config.SIG_DEVICE): "cuda" runs the card's kernels,
    # "cpu" their plain PyTorch versions (the CPU test host's oracle)
    signature_backend: Optional[str] = None
    gpu_cpu_cutover: Optional[int] = None
    sig_device: str = "cuda"
    # load (streams through node `load_target` for the whole run)
    load_accounts: int = 6
    load_txs: int = 400
    load_rate: int = 40
    load_backlog_ledgers: int = 0
    load_target: int = 0
    # per-node DESIRED_MAX_TX_PER_LEDGER override — the backlog shapes
    # need a cap SMALLER than the queued load so consecutive closes each
    # propose a full set (one giant set swallowing the whole load makes
    # the >1-close pipelined-backlog assertion hinge on which single
    # slot the burst lands in).  None keeps the Config default
    max_tx_per_ledger: Optional[int] = None
    # overlay survival plane (overlay/sendqueue.py) — None keeps the
    # Config default on every node; 0 for sendq_bytes turns the plane
    # off (the knob-off transparency leg)
    sendq_bytes: Optional[int] = None
    sendq_flood_msgs: Optional[int] = None
    straggler_stall_ms: Optional[float] = None
    # conflict-partitioned parallel apply (ledger/applysched.py) — None
    # keeps the Config default on every node; True also pins
    # APPLY_WORKERS=4 so the 1-core CI host genuinely shards instead of
    # auto-sizing to a single (serial-short-circuit) worker
    parallel_apply: Optional[bool] = None
    # floors/verdicts for the survival plane: a run must disconnect at
    # least one straggler (slow_reader), must shed at least this many
    # FLOOD frames (overload shapes), and the per-peer queue-byte
    # high-water must stay under the configured cap when set
    expect_straggler_disconnect: bool = False
    min_flood_sheds: int = 0
    assert_high_water_bounded: bool = False
    # time-slip verdicts: the run must meter at least /
    # at most this many closeTime-gate rejections (past + future,
    # summed across nodes) — the skew classes' observable
    min_slip_rejects: int = 0
    max_slip_rejects: Optional[int] = None
    # verify-at-ingest admission plane: per-node Config
    # overrides for the front door's admission knobs (None keeps the
    # Config defaults), and the flood shape's floor — the run must shed
    # at least this many invalid-sig txs at the ingest edge (metered
    # ingest.reject.badsig, summed across nodes)
    ingest_rate_limit: Optional[int] = None
    ingest_surge_high_water: Optional[int] = None
    min_ingest_sheds: int = 0
    # per-tier scoreboard aggregates: {tier_name: [node indices]} —
    # report-only grouping (targeted faults read "tier-1 undisturbed,
    # tier-2 shed" off it)
    tiers: Optional[Dict[str, List[int]]] = None
    # liveness target + floors
    target_ledgers: int = 12  # absolute min LCL across nodes at the end
    stabilize_ledgers: int = 2
    timeout: float = 300.0
    min_ledgers_per_sec: float = 0.0
    max_recovery_ms: Optional[float] = None
    # node indices EXCLUDED from the liveness target/floor (a deliberate
    # straggler cannot gate the consensus floor it is designed to miss);
    # chain agreement still covers them at the lowest common sequence
    liveness_exclude: List[int] = field(default_factory=list)
    # infrastructure
    disk_db: bool = False  # crash/restart needs on-disk sqlite
    archives: bool = False  # catchup needs a history archive
    checkpoint_frequency: int = 8
    doctor_tick: float = 1.0


@dataclass
class ScenarioResult:
    name: str
    ok: bool
    failures: List[str]
    scoreboard: LivenessScoreboard

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "failures": self.failures,
            "scoreboard": self.scoreboard.to_dict(),
        }


class Scenario:
    def __init__(self, spec: ScenarioSpec, workdir: Optional[str] = None):
        self.spec = spec
        self.workdir = workdir
        self._own_workdir = False
        self.sim: Optional[Simulation] = None
        self.node_keys: List = []
        self.loadgen: Optional[LoadGenerator] = None
        self.done = False
        self._fault_timers: List[VirtualTimer] = []
        self._doctor_timer: Optional[VirtualTimer] = None
        self._armed_at = 0.0
        self._notes: List[str] = []
        # recovery bookkeeping (heals/restarts stamp the start; the crank
        # predicate stamps the end at the first agreed post-event close)
        self._expected_recoveries = 0
        self._recovery_t0: Optional[float] = None
        self._recovery_from_lcl = 0
        self._recoveries: List[float] = []

    # -- fault-program surface ----------------------------------------------
    def note(self, msg: str) -> None:
        log.info("[%s] %s", self.spec.name, msg)
        self._notes.append(msg)

    def elapsed(self) -> float:
        return self.sim.clock.now() - self._armed_at

    def elapsed_since_arm(self) -> float:
        return self.elapsed()

    def mark_recovery_start(self) -> None:
        self._recovery_t0 = self.sim.clock.now()
        self._recovery_from_lcl = max(
            (
                app.ledger_manager.get_last_closed_ledger_num()
                for app in self.sim.nodes.values()
            ),
            default=0,
        )

    # -- build ---------------------------------------------------------------
    def _cfg(self, i: int):
        cfg = get_test_config(_INSTANCE_BASE + i)
        cfg.MANUAL_CLOSE = False
        cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = True
        cfg.SCP_SIG_SCHEME = self.spec.scp_sig_scheme
        if self.spec.signature_backend is not None:
            cfg.SIGNATURE_BACKEND = self.spec.signature_backend
        cfg.SIG_DEVICE = self.spec.sig_device
        if self.spec.gpu_cpu_cutover is not None:
            cfg.GPU_CPU_CUTOVER = self.spec.gpu_cpu_cutover
        if self.spec.sendq_bytes is not None:
            cfg.OVERLAY_SENDQ_BYTES = self.spec.sendq_bytes
        if self.spec.sendq_flood_msgs is not None:
            cfg.OVERLAY_SENDQ_FLOOD_MSGS = self.spec.sendq_flood_msgs
        if self.spec.straggler_stall_ms is not None:
            cfg.STRAGGLER_STALL_MS = self.spec.straggler_stall_ms
        if self.spec.max_tx_per_ledger is not None:
            cfg.DESIRED_MAX_TX_PER_LEDGER = self.spec.max_tx_per_ledger
        if self.spec.ingest_rate_limit is not None:
            cfg.INGEST_RATE_LIMIT = self.spec.ingest_rate_limit
        if self.spec.ingest_surge_high_water is not None:
            cfg.INGEST_SURGE_HIGH_WATER = self.spec.ingest_surge_high_water
        if self.spec.parallel_apply is not None:
            cfg.PARALLEL_APPLY = self.spec.parallel_apply
            if self.spec.parallel_apply:
                cfg.APPLY_WORKERS = 4
        if self.spec.disk_db or self.spec.archives:
            cfg.DATABASE = f"sqlite3://{self.workdir}/node{i}.db"
        if self.spec.archives:
            cfg.CHECKPOINT_FREQUENCY = self.spec.checkpoint_frequency
            archive = f"{self.workdir}/archive"
            spec = {"get": f"cp {archive}/{{0}} {{1}}"}
            if i == 0:  # one writer avoids concurrent cp races
                spec["put"] = f"cp {{0}} {archive}/{{1}}"
                spec["mkdir"] = f"mkdir -p {archive}/{{0}}"
            cfg.HISTORY = {"scenario": spec}
        return cfg

    def _build(self) -> None:
        spec = self.spec
        if (spec.disk_db or spec.archives) and self.workdir is None:
            self.workdir = tempfile.mkdtemp(prefix="stellar-tpu-scn-")
            self._own_workdir = True
        if self.spec.archives:
            import os

            os.makedirs(f"{self.workdir}/archive", exist_ok=True)
        mode = VIRTUAL_TIME if spec.clock_mode == "virtual" else REAL_TIME
        clock = VirtualClock(mode)
        overlay_mode = (
            OVER_TCP if spec.overlay_mode == "tcp" else OVER_LOOPBACK
        )
        if spec.topology == "core_and_tier":
            sim = topologies.core_and_tier(
                core_n=spec.n_nodes,
                tier_n=spec.tier_n,
                clock=clock,
                cfg_factory=self._cfg,
                mode=overlay_mode,
                tier_validators=spec.tier_validators,
            )
            self.node_keys = sim.topology_keys
        else:
            sim = Simulation(overlay_mode, clock)
            from ..crypto.keys import SecretKey

            keys = [
                SecretKey.pseudo_random_for_testing(i + 1)
                for i in range(spec.n_nodes)
            ]
            threshold = (
                spec.threshold
                if spec.threshold is not None
                else spec.n_nodes - (spec.n_nodes - 1) // 3
            )
            qset = SCPQuorumSet(
                threshold, [k.get_public_key() for k in keys], []
            )
            for i, k in enumerate(keys):
                sim.add_node(k, qset, cfg=self._cfg(i))
            for i in range(len(keys)):
                for j in range(i + 1, len(keys)):
                    sim.add_pending_connection(keys[i], keys[j])
            self.node_keys = keys
        sim.set_fault_seed(spec.seed)
        self.sim = sim

    # -- run ------------------------------------------------------------------
    def run(self) -> ScenarioResult:
        spec = self.spec
        self._build()
        sim = self.sim
        failures: List[str] = []
        try:
            sim.start_all_nodes()
            ok = sim.crank_until(
                lambda: sim.have_all_externalized(spec.stabilize_ledgers),
                spec.timeout / 3,
            )
            if not ok:
                failures.append(
                    "stabilization stuck at %s" % sim.ledger_nums()
                )
                sb = LivenessScoreboard(
                    scenario=spec.name, fault_class=spec.fault_class,
                    seed=spec.seed, clock_mode=spec.clock_mode,
                )
                return ScenarioResult(spec.name, False, failures, sb)

            # chaos window opens: snapshot, arm load + faults + doctor
            before = snapshot(sim)
            self._armed_at = sim.clock.now()
            self.loadgen = LoadGenerator(seed=spec.seed)
            self.loadgen.generate_load(
                sim.nodes[self._raw(spec.load_target)],
                spec.load_accounts,
                spec.load_txs,
                spec.load_rate,
                backlog_ledgers=spec.load_backlog_ledgers,
            )
            for f in spec.faults:
                marks_recovery = (
                    getattr(f, "heal_at", None) is not None
                    or type(f).__name__
                    in (
                        "CrashRestart",
                        "HardKillMidClose",
                        "PartitionUntilCheckpoint",
                    )
                )
                if marks_recovery:
                    self._expected_recoveries += 1
                f.arm(self)
            self._doctor(first=True)

            ok = sim.crank_until(self._target_reached, spec.timeout)
            self.done = True
            if not ok:
                failures.append(
                    "liveness target %d not reached in %.0fs: lcls=%s,"
                    " recoveries=%d/%d"
                    % (
                        spec.target_ledgers,
                        spec.timeout,
                        sim.ledger_nums(),
                        len(self._recoveries),
                        self._expected_recoveries,
                    )
                )

            after = snapshot(sim)
            tier_map = None
            if spec.tiers:
                tier_map = {
                    tier: {self._raw(i).hex()[:8] for i in idxs}
                    for tier, idxs in spec.tiers.items()
                }
            sb = LivenessScoreboard.from_snapshots(
                sim,
                before,
                after,
                exclude_nodes=self._excluded_prefixes(),
                tiers=tier_map,
                scenario=spec.name,
                fault_class=spec.fault_class,
                seed=spec.seed,
                clock_mode=spec.clock_mode,
            )
            if self._recoveries:
                sb.recovery_ms = round(max(self._recoveries), 1)
            sb.notes = list(self._notes)

            # -- verdicts ---------------------------------------------------
            if sb.invariant_violations:
                failures.append(
                    "%d ledger-invariant violation(s) under chaos"
                    % sb.invariant_violations
                )
            if not sb.ledgers_agree:
                failures.append("surviving nodes disagree on the chain")
            if spec.min_ledgers_per_sec and (
                sb.ledgers_per_sec < spec.min_ledgers_per_sec
            ):
                failures.append(
                    "liveness floor miss: %.3f < %.3f ledgers/sec"
                    % (sb.ledgers_per_sec, spec.min_ledgers_per_sec)
                )
            if spec.max_recovery_ms is not None and (
                sb.recovery_ms is None
                or sb.recovery_ms > spec.max_recovery_ms
            ):
                failures.append(
                    "recovery floor miss: %s ms (max %.0f)"
                    % (sb.recovery_ms, spec.max_recovery_ms)
                )
            # time-slip verdicts: the skew classes assert the
            # closeTime gates actually fired (beyond-slip) or stayed
            # silent (within-slip) — the metered observable, not just
            # liveness side effects
            total_slip = sb.slip_rejects_past + sb.slip_rejects_future
            if spec.min_slip_rejects and total_slip < spec.min_slip_rejects:
                failures.append(
                    "expected >= %d metered time-slip rejections, got %d"
                    % (spec.min_slip_rejects, total_slip)
                )
            if (
                spec.max_slip_rejects is not None
                and total_slip > spec.max_slip_rejects
            ):
                failures.append(
                    "%d time-slip rejections metered against a ceiling"
                    " of %d — a within-slip skew must not trip the gate"
                    % (total_slip, spec.max_slip_rejects)
                )
            # ingest-edge verdict: the flood shapes must have
            # shed their invalid-sig txs at the admission plane — before
            # check_valid, account loads, or flood fan-out spent anything
            if spec.min_ingest_sheds and (
                sb.ingest_rejects.get("badsig", 0) < spec.min_ingest_sheds
            ):
                failures.append(
                    "expected >= %d invalid-sig txs shed at the ingest"
                    " edge, got %d"
                    % (
                        spec.min_ingest_sheds,
                        sb.ingest_rejects.get("badsig", 0),
                    )
                )
            # overlay survival plane verdicts — CRITICAL is never shed,
            # in ANY scenario (the tentpole contract)
            if sb.sendq_sheds.get("critical", 0):
                failures.append(
                    "%d CRITICAL-class frames shed from a send queue —"
                    " consensus traffic must never shed"
                    % sb.sendq_sheds["critical"]
                )
            if (
                spec.min_flood_sheds
                and sb.sendq_sheds.get("flood", 0) < spec.min_flood_sheds
            ):
                failures.append(
                    "expected >= %d FLOOD-class sheds under overload, got %d"
                    % (spec.min_flood_sheds, sb.sendq_sheds.get("flood", 0))
                )
            if spec.assert_high_water_bounded:
                cap = (
                    spec.sendq_bytes
                    if spec.sendq_bytes is not None
                    else self._cfg(0).OVERLAY_SENDQ_BYTES
                )
                if cap and sb.sendq_bytes_high_water > cap:
                    if sb.sendq_oversized_admits == 0:
                        failures.append(
                            "per-peer queue-byte high-water %d exceeds"
                            " the configured cap %d"
                            % (sb.sendq_bytes_high_water, cap)
                        )
                    else:
                        # an oversized unsheddable frame admitted alone
                        # relaxes the documented per-peer bound to
                        # max(cap, that frame) — report, don't fail
                        sb.notes.append(
                            "high-water %d over cap %d under %d"
                            " oversized admit(s) — the documented"
                            " max(cap, one frame) bound applies"
                            % (
                                sb.sendq_bytes_high_water,
                                cap,
                                sb.sendq_oversized_admits,
                            )
                        )
            if spec.expect_straggler_disconnect:
                stall_budget = (
                    spec.straggler_stall_ms
                    if spec.straggler_stall_ms is not None
                    else self._cfg(0).STRAGGLER_STALL_MS
                )
                if sb.sendq_straggler_disconnects < 1:
                    failures.append(
                        "expected a straggler disconnect (ERR_LOAD) and"
                        " none happened"
                    )
                elif (
                    sb.sendq_max_stall_ms
                    > stall_budget + 1.5 * _STALL_POLL_SLACK_MS
                ):
                    # the stall timer fires AT the head's deadline on the
                    # virtual clock; any observed stall materially past
                    # the budget means detection drifted
                    failures.append(
                        "straggler stalled %.0f ms against a %.0f ms"
                        " budget — disconnect landed outside the window"
                        % (sb.sendq_max_stall_ms, stall_budget)
                    )
            for f in spec.faults:
                # fault-specific verdicts (the hard-kill class asserts
                # its kill fired and the restarted node's self-check
                # repaired; future classes plug in the same way)
                outcome = getattr(f, "verify_outcome", None)
                if outcome is not None:
                    outcome(failures)
            for f in spec.faults:
                checker = getattr(f, "assert_cache_unpolluted", None)
                if checker is not None:
                    try:
                        checked = checker()
                        self._notes.append(
                            "verify cache clean across %d flooded"
                            " invalid-sig envelopes" % checked
                        )
                    except AssertionError as e:
                        failures.append(str(e))
                fetchers = getattr(f, "n_envelopes", None)
                if fetchers:
                    # the fetch plane must not have wedged on made-up
                    # hashes (the eager-reject defense the flood attacks)
                    for raw, app in sim.nodes.items():
                        info = app.herder.pending_envelopes.dump_info()
                        wedged = sum(info["fetching"].values())
                        if wedged:
                            failures.append(
                                "node %s wedged %d envelopes in the fetch"
                                " plane under flood" % (raw.hex()[:8], wedged)
                            )
            sb.notes = list(self._notes)
            return ScenarioResult(spec.name, not failures, failures, sb)
        finally:
            self.done = True
            for f in spec.faults:
                # remove any process-global fs kill hooks a fault armed
                disarm = getattr(f, "disarm", None)
                if disarm is not None:
                    disarm()
            for t in self._fault_timers:
                t.cancel()
            if self._doctor_timer is not None:
                self._doctor_timer.cancel()
            if self.loadgen is not None:
                self.loadgen.stop()
            sim.stop_all_nodes()
            sim.clock.shutdown()
            if self._own_workdir:
                shutil.rmtree(self.workdir, ignore_errors=True)

    # -- internals ------------------------------------------------------------
    def _raw(self, idx: int) -> bytes:
        return Simulation._raw_key(self.node_keys[idx])

    def _excluded_raw(self) -> set:
        return {self._raw(i) for i in self.spec.liveness_exclude}

    def _excluded_prefixes(self) -> set:
        return {r.hex()[:8] for r in self._excluded_raw()}

    def _liveness_lcls(self) -> List[int]:
        """LCLs of the liveness-gated nodes (the spec's deliberate
        straggler, if any, is excluded from the floor it cannot meet)."""
        excluded = self._excluded_raw()
        return [
            app.ledger_manager.get_last_closed_ledger_num()
            for raw, app in self.sim.nodes.items()
            if raw not in excluded
        ]

    def _doctor(self, first: bool = False) -> None:
        """Link doctor tick: re-establish flapped/expected links (lossy
        links kill connections via MAC-sequence breaks; restarts rejoin
        here too), then re-arm."""
        if self.done:
            return
        if not first:
            self.sim.ensure_links()
        if self._doctor_timer is None:
            self._doctor_timer = VirtualTimer(self.sim.clock)
        self._doctor_timer.expires_from_now(self.spec.doctor_tick)
        self._doctor_timer.async_wait(self._doctor)

    def _target_reached(self) -> bool:
        sim = self.sim
        lcls = self._liveness_lcls()
        if not lcls:
            return False
        # recovery stamp: first moment every surviving node moved past the
        # pre-heal high-water mark in lockstep
        if self._recovery_t0 is not None:
            if min(lcls) > self._recovery_from_lcl and min(lcls) == max(lcls):
                self._recoveries.append(
                    (sim.clock.now() - self._recovery_t0) * 1000.0
                )
                self._recovery_t0 = None
        return (
            min(lcls) >= self.spec.target_ledgers
            and len(self._recoveries) >= self._expected_recoveries
        )
