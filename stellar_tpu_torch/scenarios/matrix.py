"""The scenario matrix — named shapes per fault class.

SMALL shapes run in tier-1 (each ≥10 ledgers closed in the chaos window,
invariants all-on, deterministic seeded replay for the virtual-clock
classes); BIG shapes are the same programs at core-and-tier ring scale
and longer fault windows, behind ``-m slow`` / the relay_watch
``scenario_liveness_r12`` step's ``--matrix big`` mode.

Fault classes (ROADMAP #5):
- ``partition_heal``    — majority/minority split, heal, lagging node
                          replays the missed slots through ClosePipeline
- ``byzantine_flood``   — invalid-signature envelope + tx flood at volume
                          (strict-gate fast-reject, CALLER_OVERLAY plane)
- ``byzantine_flood_halfagg`` — the same invalid flood plus a VALID-
                          signature ballot storm under
                          SCP_SIG_SCHEME="ed25519-halfagg":
                          storm buckets verify as aggregate MSM checks;
                          the paired per-signature A/B compares scheme
                          verify wall at the same rate
- ``slow_lossy``        — latency + loss/duplicate/reorder/damage on every
                          link; flapped connections re-established by the
                          link doctor
- ``crash_restart``     — validator hard-crash with a 3-of-3 quorum (the
                          network halts) and restart from its on-disk
                          state; recovery time measured
- ``hard_kill_mid_close`` — a REAL kill (not graceful_stop):
                          a storage-fault injector unwinds the node's
                          in-flight close at a named durable-write
                          kill-point (close.pre-commit) and reaps it
                          with no shutdown hooks; the restart must pass
                          the boot self-check (main/selfcheck.py)
                          before consensus recovers
- ``catchup_load``      — node partitioned past MAX_SLOTS_TO_REMEMBER
                          while the network closes through checkpoint
                          boundaries under load; rejoin via history-archive
                          catchup (REAL_TIME clock, like the history suite)
- ``slow_reader``       — one tier peer drains its links at a fraction of
                          the offered rate: neighbors shed
                          FLOOD toward it, never CRITICAL, and disconnect
                          it (ERR_LOAD) inside the straggler stall budget;
                          consensus floor asserted over everyone else
- ``overload_storm``    — tx flood at several times total drain capacity
                          across all links: FLOOD sheds at every queue,
                          CRITICAL jumps them, queue-byte high-water stays
                          under OVERLAY_SENDQ_BYTES, liveness floor holds
- ``clock_skew_within_slip`` — per-node clock offsets INSIDE the
                          MAX_TIME_SLIP_SECONDS acceptance window (static
                          +30s on one node, slow drift on another): the
                          closeTime gates must stay silent (0 metered
                          rejections) and the consensus floor must hold —
                          the tolerance the protocol promises
- ``clock_skew_beyond_slip`` — an NTP-step skew BEYOND the slip window:
                          the skewed node rejects the quorum's values
                          (herder.value.reject-closetime-future metered,
                          ≥1 asserted) and stalls while the unskewed
                          majority keeps its floor; when the skew heals
                          (lag-polled, inside the SCP replay window) the
                          node replays the missed slots and recovery is
                          measured against a floor
- ``asymmetric_partition`` — ONE-WAY isolation of a tier-1 node (frames
                          toward it dropped pre-MAC, its own frames keep
                          flowing — the half-open connection the
                          symmetric groups API cannot express): links
                          never flap, the deaf node stalls, heal resumes
                          the same connections and recovery is measured
- ``targeted_flood_tier2`` — byzantine flood + drain-capped overload
                          storm aimed ONLY at tier-2 nodes of a
                          core-and-tier ring: tier-1 holds its
                          undisturbed floor, tier-2 sheds FLOOD through
                          the send queues, 0 CRITICAL sheds anywhere
                          (per-tier scoreboard aggregates carry the
                          verdict)
- ``byzantine_flood_gpu`` — the byzantine flood with the DEVICE batch
                          plane engaged (SIGNATURE_BACKEND="gpu",
                          cutover 0): every overlay flush rides the
                          verify kernel (on the card, or its plain
                          version with sig_device="cpu") and the
                          CALLER_OVERLAY wedge-latch contract is
                          pinned under flood
- ``ingest_flood``      — sustained LoadGenerator stream + byzantine
                          invalid-sig TX flood through the verify-at-
                          ingest front door at 10x the legit arrival
                          rate: every flooded tx sheds at
                          the edge (ingest.reject.badsig) before
                          check_valid or fan-out, the verify cache
                          stays clean (valid-only latch), the liveness
                          floor holds, two-run deterministic replay
- ``tcp_scale``         — the 100+ node core-and-tier shape OVER REAL
                          TCP SOCKETS (big matrix / -m slow only): the
                          sendqueue + pack-once fan-out planes at
                          production-transport scale, ≥5 ledgers
                          externalized with per-tier aggregates
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..overlay.loopback import FaultProfile
from .faults import (
    AsymmetricPartition,
    ByzantineFlood,
    ClockSkew,
    CrashRestart,
    HardKillMidClose,
    IngestFlood,
    OverloadStorm,
    Partition,
    PartitionUntilCheckpoint,
    SlowLossyLinks,
    SlowReader,
)
from .scenario import Scenario, ScenarioResult, ScenarioSpec

FAULT_CLASSES = (
    "partition_heal",
    "byzantine_flood",
    "byzantine_flood_halfagg",
    "byzantine_flood_gpu",
    "ingest_flood",
    "slow_lossy",
    "crash_restart",
    "hard_kill_mid_close",
    "catchup_load",
    "slow_reader",
    "overload_storm",
    "clock_skew_within_slip",
    "clock_skew_beyond_slip",
    "asymmetric_partition",
    "targeted_flood_tier2",
    "tcp_scale",
)


def small_specs(seed: int = 1) -> Dict[str, ScenarioSpec]:
    """Tier-1 shapes: 3 nodes, ≥10 chaos-window ledgers each."""
    return {
        "partition_heal": ScenarioSpec(
            name="partition_heal_small",
            fault_class="partition_heal",
            n_nodes=3,
            threshold=2,  # 2-of-3: the majority side must keep closing
            seed=seed,
            # heal at exactly 3 ledgers of lag: within the SCP state
            # window (send_scp_state_to_peer replays max-3..max), so the
            # minority node replays the missed slots from peers' state —
            # the reentrant-externalize ClosePipeline backlog; heal_at is
            # the backstop if leader-election stalls starve the majority
            faults=[
                Partition(
                    at=0.5, heal_at=12.0, groups=[[0, 1], [2]], heal_lag=3
                )
            ],
            load_backlog_ledgers=2,
            # cap well under load_txs: the 400-tx load spreads over ≥4
            # consecutive FULL closes instead of one uncapped burst slot,
            # so the healed node's replay window carries txful sets
            # wherever the ready-sweep boundaries land (the dispatched≥1
            # assertion must not hinge on which slot one burst hits)
            max_tx_per_ledger=100,
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            max_recovery_ms=15_000,
            timeout=180.0,
        ),
        "byzantine_flood": ScenarioSpec(
            name="byzantine_flood_small",
            fault_class="byzantine_flood",
            n_nodes=3,
            seed=seed,
            faults=[
                ByzantineFlood(
                    at=0.5, until=7.0, target=0,
                    envelopes_per_tick=25, txs_per_tick=5, tick=0.4,
                )
            ],
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            timeout=180.0,
        ),
        # the aggregate-scheme flood leg: the SAME invalid
        # flood plus a VALID-signature ballot storm — the expensive flood
        # class, where every envelope passes the strict gate and pays
        # full curve math.  Under "ed25519-halfagg" each crank's storm
        # bucket verifies as ONE aggregate MSM check; the paired A/B in
        # tests/test_scenarios.py runs this identical spec under
        # "ed25519" and asserts the per-signature path pays >= ~2x the
        # scheme verify wall at the same rate (the wall that wedges a
        # flooded crank), while this leg holds the same liveness floor
        # with the cache provably clean of aggregate-path pollution.
        "byzantine_flood_halfagg": ScenarioSpec(
            name="byzantine_flood_halfagg_small",
            fault_class="byzantine_flood_halfagg",
            n_nodes=3,
            seed=seed,
            scp_sig_scheme="ed25519-halfagg",
            faults=[
                ByzantineFlood(
                    at=0.5, until=7.0, target=0,
                    envelopes_per_tick=10, txs_per_tick=2, tick=0.4,
                    storm_per_tick=240,
                )
            ],
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            timeout=180.0,
        ),
        "slow_lossy": ScenarioSpec(
            name="slow_lossy_small",
            fault_class="slow_lossy",
            n_nodes=3,
            seed=seed,
            faults=[
                SlowLossyLinks(
                    at=0.5,
                    profile=FaultProfile(
                        drop=0.005, duplicate=0.005, reorder=0.01,
                        damage=0.002, latency=0.05,
                    ),
                )
            ],
            # every fault roll that fires flaps the CONNECTION (MAC
            # sequence break) and costs a latency-taxed re-handshake, so
            # liveness degrades by design here; the floor asserts the
            # network still grinds forward, not that it stays fast
            doctor_tick=0.5,
            target_ledgers=14,
            min_ledgers_per_sec=0.04,
            timeout=400.0,
        ),
        "crash_restart": ScenarioSpec(
            name="crash_restart_small",
            fault_class="crash_restart",
            n_nodes=3,
            threshold=3,  # 3-of-3: the crash halts consensus outright
            seed=seed,
            disk_db=True,
            faults=[CrashRestart(at=2.0, restart_at=8.0, node=2)],
            target_ledgers=14,
            min_ledgers_per_sec=0.1,
            max_recovery_ms=20_000,
            timeout=240.0,
        ),
        # the storage survival plane's chaos class: a REAL
        # kill — the injector unwinds node 2's close at close.pre-commit
        # (every durable close artifact staged, COMMIT not run) and the
        # node is reaped with NO graceful shutdown; 3-of-3 quorum so the
        # kill halts consensus outright, and the restart must pass the
        # boot self-check before recovery is measured.  Deterministic
        # two-run replay like crash_restart.
        "hard_kill_mid_close": ScenarioSpec(
            name="hard_kill_mid_close_small",
            fault_class="hard_kill_mid_close",
            n_nodes=3,
            threshold=3,
            seed=seed,
            disk_db=True,
            faults=[HardKillMidClose(at=2.0, restart_at=8.0, node=2)],
            target_ledgers=14,
            min_ledgers_per_sec=0.1,
            max_recovery_ms=20_000,
            timeout=240.0,
        ),
        # the overlay survival plane's two shapes.  Caps are
        # deliberately SMALL (32 KiB vs the 2 MiB production default) so
        # the defenses engage at test-scale traffic; every knob is a
        # per-node Config override through the spec.
        "slow_reader": ScenarioSpec(
            name="slow_reader_small",
            fault_class="slow_reader",
            # 3-core mesh + 2-node tier ring; the slow reader is tier
            # node 4 (links to tier node 3 + core node 1): its quorum
            # slice rides the core, so disconnecting it costs nobody
            # else a vote
            topology="core_and_tier",
            n_nodes=3,
            tier_n=2,
            seed=seed,
            sendq_bytes=32 * 1024,
            sendq_flood_msgs=64,
            straggler_stall_ms=1500,
            faults=[
                SlowReader(at=0.5, node=4, drain_bytes_per_sec=2048)
            ],
            load_txs=600,
            load_rate=50,
            # the straggler cannot meet the floor it is built to miss
            liveness_exclude=[4],
            expect_straggler_disconnect=True,
            min_flood_sheds=1,
            assert_high_water_bounded=True,
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            timeout=240.0,
        ),
        "overload_storm": ScenarioSpec(
            name="overload_storm_small",
            fault_class="overload_storm",
            n_nodes=3,
            seed=seed,
            sendq_bytes=32 * 1024,
            sendq_flood_msgs=48,
            straggler_stall_ms=2500,
            faults=[
                OverloadStorm(
                    at=0.5, until=8.0, source=0,
                    msgs_per_tick=30, tick=0.25,
                    drain_bytes_per_sec=16384,
                )
            ],
            # light legit load: the storm supplies the flood pressure;
            # txsets stay small enough that FETCH replies clear the
            # drain-capped links
            load_accounts=4,
            load_txs=120,
            load_rate=15,
            min_flood_sheds=10,
            assert_high_water_bounded=True,
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            timeout=240.0,
        ),
        # the time-and-asymmetry plane.  Within-slip: one
        # node statically +30s ahead (half the 60s MAX_TIME_SLIP window)
        # and another drifting at +20ms/s — tolerable skew the protocol
        # promises to absorb: the closeTime gates must meter NOTHING and
        # the floor is the undisturbed one.
        "clock_skew_within_slip": ScenarioSpec(
            name="clock_skew_within_slip_small",
            fault_class="clock_skew_within_slip",
            n_nodes=3,
            threshold=2,
            seed=seed,
            faults=[
                ClockSkew(at=0.5, node=2, offset=30.0),
                ClockSkew(at=0.5, node=1, drift_per_sec=0.02),
            ],
            max_slip_rejects=0,
            target_ledgers=14,
            min_ledgers_per_sec=0.5,
            timeout=180.0,
        ),
        # Beyond-slip: node 2's clock NTP-steps 90s BEHIND shortly after
        # the window opens, so every honest value reads >60s in the
        # future through its skewed gate — it stalls, metering
        # reject-closetime-future, while the 2-of-3 majority keeps its
        # floor.  The lag-polled heal (inside the SCP replay window)
        # models the operator fixing NTP; the node must replay the
        # missed slots and the recovery clock has a floor.
        "clock_skew_beyond_slip": ScenarioSpec(
            name="clock_skew_beyond_slip_small",
            fault_class="clock_skew_beyond_slip",
            n_nodes=3,
            threshold=2,
            seed=seed,
            faults=[
                ClockSkew(
                    at=0.5, node=2, offset=-90.0, step_at=0.5,
                    heal_lag=3, heal_at=12.0,
                )
            ],
            load_backlog_ledgers=2,
            min_slip_rejects=1,
            target_ledgers=14,
            min_ledgers_per_sec=0.5,
            max_recovery_ms=15_000,
            timeout=180.0,
        ),
        # One-way isolation of a tier-1 node: node 2 is heard but hears
        # nothing (rest→2 dropped pre-MAC; 2→rest delivered) — the
        # half-open-connection case.  Links stay up the whole time; the
        # deaf node keeps voting into the void, stalls, and after the
        # lag-polled heal replays the missed slots from the still-open
        # connections' SCP rebroadcast.
        "asymmetric_partition": ScenarioSpec(
            name="asymmetric_partition_small",
            fault_class="asymmetric_partition",
            n_nodes=3,
            threshold=2,
            seed=seed,
            faults=[
                AsymmetricPartition(
                    at=0.5, deaf=[2], heal_lag=3, heal_at=12.0
                )
            ],
            load_backlog_ledgers=2,
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            max_recovery_ms=15_000,
            timeout=180.0,
        ),
        # Targeted tier flood: invalid-sig envelope/tx flood injected
        # ONLY into the tier-2 ring nodes, plus a drain-capped overload
        # storm broadcast from a tier node across tier-touching links
        # only.  Tier-1's core mesh is untouched — its floor is the
        # UNDISTURBED one (vs the 0.2 global floors above) — while
        # tier-2 sheds FLOOD through the send queues; per-tier
        # aggregates carry the verdict, and 0 CRITICAL sheds anywhere.
        "targeted_flood_tier2": ScenarioSpec(
            name="targeted_flood_tier2_small",
            fault_class="targeted_flood_tier2",
            topology="core_and_tier",
            n_nodes=3,
            tier_n=2,
            seed=seed,
            sendq_bytes=32 * 1024,
            sendq_flood_msgs=48,
            straggler_stall_ms=2500,
            faults=[
                ByzantineFlood(
                    at=0.5, until=8.0, targets=[3, 4],
                    envelopes_per_tick=15, txs_per_tick=3, tick=0.4,
                ),
                OverloadStorm(
                    at=0.5, until=8.0, source=3,
                    msgs_per_tick=25, tick=0.25,
                    drain_bytes_per_sec=16384,
                    drain_nodes=[3, 4],
                ),
            ],
            load_accounts=4,
            load_txs=120,
            load_rate=15,
            tiers={"tier1": [0, 1, 2], "tier2": [3, 4]},
            liveness_exclude=[3, 4],
            min_flood_sheds=1,
            assert_high_water_bounded=True,
            target_ledgers=14,
            min_ledgers_per_sec=0.5,
            timeout=240.0,
        ),
        # The gpu-backend flood leg (ROADMAP 6(a)): the byzantine flood
        # with the DEVICE batch plane engaged — SIGNATURE_BACKEND="gpu"
        # with cutover 0 routes every overlay flush (honest + flood)
        # through BatchVerifier's device dispatch: the card's verify
        # kernel, or its plain version with sig_device="cpu".  The test pins the
        # CALLER_OVERLAY wedge-latch contract: zero wedge fallbacks and
        # zero latch flips under flood, verdicts identical to the cpu
        # path (same floors, same cache-cleanliness oracle).
        "byzantine_flood_gpu": ScenarioSpec(
            name="byzantine_flood_gpu_small",
            fault_class="byzantine_flood_gpu",
            n_nodes=3,
            seed=seed,
            signature_backend="gpu",
            gpu_cpu_cutover=0,
            faults=[
                ByzantineFlood(
                    at=0.5, until=7.0, target=0,
                    envelopes_per_tick=25, txs_per_tick=5, tick=0.4,
                )
            ],
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            timeout=180.0,
        ),
        # the admission-plane flood leg: the LoadGenerator's
        # legit stream (40 tx/s) keeps flowing while a byzantine flood
        # of invalid-sig txs FROM THE EXISTING ROOT ACCOUNT (so the
        # candidate triples hint-match and the edge shed — not
        # check_valid — is the defense that fires) hits node 0's ingest
        # front door at 400 tx/s, 10x the legit rate.  Every flooded tx
        # must shed at the edge (spec floor + the fault's exact-count
        # oracle), the verify cache stays clean, and the close cadence
        # holds the same floor as the un-flooded shapes.
        "ingest_flood": ScenarioSpec(
            name="ingest_flood_small",
            fault_class="ingest_flood",
            n_nodes=3,
            seed=seed,
            faults=[
                IngestFlood(
                    at=0.5, until=7.0, target=0,
                    txs_per_tick=100, tick=0.25,
                )
            ],
            min_ingest_sheds=2000,
            target_ledgers=14,
            min_ledgers_per_sec=0.2,
            timeout=180.0,
        ),
        "catchup_load": ScenarioSpec(
            name="catchup_load_small",
            fault_class="catchup_load",
            n_nodes=3,
            threshold=2,  # majority keeps closing while the lagger is cut
            seed=seed,
            clock_mode="real",  # archive get/put are real subprocesses
            disk_db=True,
            archives=True,
            checkpoint_frequency=8,
            faults=[
                PartitionUntilCheckpoint(
                    at=1.0, heal_after_ledger=12, lagger=2
                )
            ],
            load_backlog_ledgers=1,
            target_ledgers=18,
            # real-clock scenario: wall time includes archive subprocess
            # latency; the floor stays conservative
            min_ledgers_per_sec=0.05,
            timeout=150.0,
        ),
    }


def big_specs(seed: int = 1) -> Dict[str, ScenarioSpec]:
    """Core-and-tier ring scale (-m slow / scenario_liveness_r12 --matrix
    big): 4-core + 4-tier ring, longer fault windows, bigger floods —
    plus the big-only ``tcp_scale`` 100+ node OVER_TCP shape."""
    small = small_specs(seed)
    out: Dict[str, ScenarioSpec] = {}
    for cls, spec in small.items():
        big = ScenarioSpec(**{**spec.__dict__})
        big.name = spec.name.replace("_small", "_big")
        big.topology = "core_and_tier"
        big.n_nodes = 4
        big.tier_n = 4
        big.threshold = None
        big.target_ledgers = spec.target_ledgers + 16
        big.timeout = spec.timeout * 3
        big.load_txs = 1200
        if cls == "byzantine_flood":
            big.faults = [
                ByzantineFlood(
                    at=0.5, until=20.0, target=0,
                    envelopes_per_tick=100, txs_per_tick=20, tick=0.4,
                )
            ]
        elif cls == "byzantine_flood_halfagg":
            big.faults = [
                ByzantineFlood(
                    at=0.5, until=20.0, target=0,
                    envelopes_per_tick=40, txs_per_tick=8, tick=0.4,
                    storm_per_tick=400,
                )
            ]
        elif cls == "partition_heal":
            # cut the ring AND a core node off the rest
            big.faults = [
                Partition(
                    at=0.5, heal_at=4.0,
                    groups=[[0, 1, 2], [3, 4, 5, 6, 7]],
                )
            ]
            big.max_recovery_ms = 30_000
        elif cls == "crash_restart":
            # 8-node shape keeps BFT majority; crash a TIER node so ring
            # consensus must route around it, then recover on restart
            big.faults = [CrashRestart(at=2.0, restart_at=10.0, node=5)]
            big.threshold = None
            big.max_recovery_ms = 40_000
        elif cls == "hard_kill_mid_close":
            # hard-kill a TIER node mid-close while the ring keeps
            # closing; the restart must self-check + replay the gap
            big.faults = [
                HardKillMidClose(at=2.0, restart_at=10.0, node=5)
            ]
            big.threshold = None
            big.max_recovery_ms = 40_000
        elif cls == "catchup_load":
            big.faults = [
                PartitionUntilCheckpoint(
                    at=1.0, heal_after_ledger=20, lagger=7
                )
            ]
            big.target_ledgers = 26
        elif cls == "slow_reader":
            # 4-core + 4-tier ring; the slow reader is the last tier node
            big.faults = [
                SlowReader(at=0.5, node=7, drain_bytes_per_sec=2048)
            ]
            big.liveness_exclude = [7]
        elif cls == "overload_storm":
            big.faults = [
                OverloadStorm(
                    at=0.5, until=20.0, source=0,
                    msgs_per_tick=80, tick=0.25,
                    drain_bytes_per_sec=16384,
                )
            ]
            big.load_txs = 300
        elif cls == "byzantine_flood_gpu":
            big.faults = [
                ByzantineFlood(
                    at=0.5, until=20.0, target=0,
                    envelopes_per_tick=50, txs_per_tick=10, tick=0.4,
                )
            ]
        elif cls == "ingest_flood":
            big.faults = [
                IngestFlood(
                    at=0.5, until=20.0, target=0,
                    txs_per_tick=200, tick=0.25,
                )
            ]
            big.min_ingest_sheds = 10_000
        elif cls in ("clock_skew_within_slip", "clock_skew_beyond_slip"):
            # node 2 is a core node in the 4+4 shape; the core's 3-of-4
            # majority absorbs a beyond-slip stall exactly like the
            # small shape's 2-of-3
            pass
        elif cls == "asymmetric_partition":
            pass  # deaf=[2] — core node, 3-of-4 majority holds
        elif cls == "targeted_flood_tier2":
            # re-aim at the 4-node tier ring of the 4+4 shape
            big.faults = [
                ByzantineFlood(
                    at=0.5, until=20.0, targets=[4, 5, 6, 7],
                    envelopes_per_tick=15, txs_per_tick=3, tick=0.4,
                ),
                OverloadStorm(
                    at=0.5, until=20.0, source=4,
                    msgs_per_tick=40, tick=0.25,
                    drain_bytes_per_sec=16384,
                    drain_nodes=[4, 5, 6, 7],
                ),
            ]
            big.tiers = {"tier1": [0, 1, 2, 3], "tier2": [4, 5, 6, 7]}
            big.liveness_exclude = [4, 5, 6, 7]
            big.load_txs = 300
        out[cls] = big
    # the big-only scale shape (ROADMAP 6(b')): 4-core +
    # 96-tier ring over REAL localhost TCP sockets — the per-peer
    # bounded send queues and pack-once fan-out at production-transport
    # scale.  Real clock (socket delivery is kernel-timed; the digest
    # policy already excludes counters for real-clock runs), no
    # link-level faults (loopback-only knobs), floors: ≥5 ledgers
    # externalized by every one of the 100 nodes inside the timeout.
    out["tcp_scale"] = ScenarioSpec(
        name="tcp_scale_100",
        fault_class="tcp_scale",
        topology="core_and_tier",
        overlay_mode="tcp",
        clock_mode="real",
        n_nodes=4,
        tier_n=96,
        # watchers: a 4-core committee decides, 96 tier nodes track and
        # relay — 100 independent nominators churn nomination for
        # minutes/slot, which is a different (known) pathology than the
        # transport-scale claim this shape certifies
        tier_validators=False,
        seed=seed,
        faults=[],
        load_accounts=4,
        load_txs=80,
        load_rate=10,
        tiers={"tier1": [0, 1, 2, 3], "tier2": list(range(4, 100))},
        target_ledgers=7,
        stabilize_ledgers=2,
        min_ledgers_per_sec=0.0,
        timeout=900.0,
    )
    return out


def run_matrix(
    matrix: str = "small",
    only: Optional[List[str]] = None,
    seed: int = 1,
    workdir: Optional[str] = None,
    signature_backend: Optional[str] = None,
) -> List[ScenarioResult]:
    specs = small_specs(seed) if matrix == "small" else big_specs(seed)
    if signature_backend is not None:
        # one backend for every node of every class (the CLI's
        # --signature-backend)
        specs = {
            cls: dataclasses.replace(spec, signature_backend=signature_backend)
            for cls, spec in specs.items()
        }
    if only:
        # an EXPLICIT request for a class this matrix doesn't carry must
        # not read as a green (empty) run — raise for every caller
        # (bench, tests), not just the CLI's own pre-check
        missing = [c for c in only if c not in specs]
        if missing:
            raise ValueError(
                "fault class(es) not in the %s matrix: %s"
                % (matrix, ",".join(missing))
            )
    results = []
    for cls in FAULT_CLASSES:
        if only and cls not in only:
            continue
        if cls not in specs:
            continue  # big-only shape (tcp_scale) absent from small
        results.append(Scenario(specs[cls], workdir=workdir).run())
    return results
