"""LivenessScoreboard — what the chaos plane measures.

A scenario is only as good as its verdict: every run emits one scoreboard
covering consensus liveness (ledgers closed / wall time, nomination and
ballot rounds burned), the flood plane (fan-out, strict-gate fast
rejects), the close pipeline's overlap stats, recovery time after a
heal/restart, and the invariant plane's violation count.  The scoreboard
is built from COUNTER DELTAS between two snapshots, so the stabilization
phase before the fault program arms never pollutes the chaos window.

``digest()`` is the deterministic-replay oracle:
same topology + seed + fault program ⇒ identical digest across runs.  It
deliberately covers only clock-deterministic fields — worker-thread
timing artifacts (pipeline joined_warm, overlap ms) are reported but
excluded.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..crypto import sha256


_PIPE_KEYS = (
    "dispatched", "joined", "joined_warm", "quarantined",
    "overlap_hidden_ms", "backlog_drains",
)

# SCP signature-scheme plane (crypto/aggregate/): flushed envelope count
# and verify wall are reported for BOTH schemes (the flood A/B compares
# verify_wall_ms across schemes at the same storm); the agg_* counters
# stay zero under the per-envelope scheme.  Wall is thread/host timing —
# reported, never digested.
_AGG_KEYS = (
    "flush_envelopes", "verify_wall_ms", "agg_checks", "agg_envelopes",
    "fallback_envelopes", "gate_rejects",
)

# overlay survival plane (overlay/sendqueue.py): per-class send-side
# sheds + straggler disconnects are crank-deterministic counters (they
# join the virtual-mode digest); bytes_high_water/max_stall_ms are
# node-level maxima (taken from the AFTER snapshot, monotone per node)
# and recv_load_sheds is the LoadManager's receive-side decision count.
_SENDQ_DELTA_KEYS = (
    "shed_critical", "shed_fetch", "shed_flood", "shed_gossip",
    "stragglers", "oversized_admits",
)
_SENDQ_MAX_KEYS = ("bytes_high_water", "max_stall_ms")


def _node_counters(app) -> Dict[str, int]:
    h = app.herder
    om = app.overlay_manager
    inv = getattr(app, "invariants", None)
    pipe = getattr(app, "close_pipeline", None)
    pipe_stats = pipe.stats() if pipe is not None else {}
    scheme = getattr(app, "scp_scheme", None)
    scheme_stats = scheme.stats() if scheme is not None else {}
    out = {
        "pipe." + k: pipe_stats.get(k, 0) for k in _PIPE_KEYS
    }
    out.update(
        {"agg." + k: scheme_stats.get(k, 0) for k in _AGG_KEYS}
    )
    sq = getattr(om, "sendq_stats", None) if om else None
    if sq is not None:
        from ..overlay.sendqueue import (
            CLASS_CRITICAL, CLASS_FETCH, CLASS_FLOOD, CLASS_GOSSIP,
        )

        out.update({
            "sendq.shed_critical": sq.shed_msgs[CLASS_CRITICAL],
            "sendq.shed_fetch": sq.shed_msgs[CLASS_FETCH],
            "sendq.shed_flood": sq.shed_msgs[CLASS_FLOOD],
            "sendq.shed_gossip": sq.shed_msgs[CLASS_GOSSIP],
            "sendq.stragglers": sq.straggler_disconnects,
            "sendq.oversized_admits": sq.oversized_admits,
            "sendq.bytes_high_water": sq.bytes_high_water,
            "sendq.max_stall_ms": sq.max_stall_ms,
        })
    else:
        out.update({"sendq." + k: 0 for k in _SENDQ_DELTA_KEYS})
        out.update({"sendq." + k: 0 for k in _SENDQ_MAX_KEYS})
    ing = getattr(app, "ingest", None)
    out.update({
        # verify-at-ingest admission plane (ingest/plane.py):
        # edge sheds per reject class + admitted txs + flush count, all
        # crank-deterministic (the badsig sheds join the digest)
        "ingest.reject_badsig": ing.m_reject_badsig.count if ing else 0,
        "ingest.reject_ratelimit": ing.m_reject_rate.count if ing else 0,
        "ingest.reject_surge": ing.m_reject_surge.count if ing else 0,
        "ingest.admitted": ing.m_admit.count if ing else 0,
        "ingest.flushes": ing.m_flush.count if ing else 0,
    })
    out.update({
        "recv_load_sheds": (
            om.load_manager.n_sheds
            if om and getattr(om, "load_manager", None) is not None
            else 0
        ),
        "externalized": h.m_value_externalize.count if h else 0,
        # time-slip rejections: the herder's closeTime gates
        # — under clock skew these are the defense that fires; crank-
        # deterministic, so they join the virtual-mode digest
        "slip_rejects_past": h.m_value_close_past.count if h else 0,
        "slip_rejects_future": h.m_value_close_future.count if h else 0,
        "nomination_rounds": h.n_nomination_rounds if h else 0,
        "ballot_rounds": h.n_ballot_rounds if h else 0,
        "envelopes_emitted": h.m_envelope_emit.count if h else 0,
        "envelopes_received": h.m_envelope_receive.count if h else 0,
        "envelopes_invalid_sig": h.m_envelope_invalidsig.count if h else 0,
        "flood_fanout": om.floodgate.n_sent if om else 0,
        "scp_batch_rejected": om.m_scp_batch_rejected.count if om else 0,
        "invariant_violations": inv.total_violations if inv else 0,
    })
    return out


@dataclass
class Snapshot:
    at: float
    lcls: Dict[str, int]
    counters: Dict[str, Dict[str, int]]  # node hex prefix -> counters


def snapshot(sim) -> Snapshot:
    return Snapshot(
        at=sim.clock.now(),
        lcls={
            raw.hex()[:8]: app.ledger_manager.get_last_closed_ledger_num()
            for raw, app in sim.nodes.items()
        },
        counters={
            raw.hex()[:8]: _node_counters(app)
            for raw, app in sim.nodes.items()
        },
    )


@dataclass
class LivenessScoreboard:
    scenario: str = ""
    fault_class: str = ""
    seed: int = 0
    clock_mode: str = "virtual"
    # liveness
    ledgers_closed: int = 0  # min across surviving nodes, chaos window
    wall_seconds: float = 0.0
    ledgers_per_sec: float = 0.0
    nomination_rounds: int = 0
    ballot_rounds: int = 0
    # flood plane
    envelopes_emitted: int = 0
    envelopes_received: int = 0
    flood_fanout: int = 0
    fast_rejects: int = 0  # invalid-sig envelopes rejected (eager + batch)
    fast_reject_rate_per_sec: float = 0.0
    # time-and-asymmetry plane: closeTime-gate rejections —
    # a skewed node rejecting the quorum's values reads as `future` on
    # the skewed node; a forward-skewed proposer's values read as
    # `future` on everyone else.  Crank-deterministic, digested.
    slip_rejects_past: int = 0
    slip_rejects_future: int = 0
    # recovery
    recovery_ms: Optional[float] = None  # heal/restart -> next agreed close
    # correctness
    invariant_violations: int = 0
    ledgers_agree: bool = True
    final_lcls: Dict[str, int] = field(default_factory=dict)
    final_hash: str = ""  # ledger hash at the lowest common sequence
    # overlay survival plane (overlay/sendqueue.py): send-side sheds per
    # class (window deltas; CRITICAL must stay 0 — Scenario.run fails any
    # run that sheds it), straggler disconnects, and node-level maxima
    # for queue-byte high-water / observed CRITICAL stall
    sendq_sheds: Dict[str, int] = field(default_factory=dict)
    sendq_straggler_disconnects: int = 0
    # unsheddable frames bigger than the whole cap admitted alone on an
    # empty queue: while one is queued the documented per-peer bound is
    # max(cap, that frame), so the high-water verdict must not read a
    # breach off the raw cap when these occurred
    sendq_oversized_admits: int = 0
    sendq_bytes_high_water: int = 0
    sendq_max_stall_ms: float = 0.0
    recv_load_sheds: int = 0  # LoadManager (receive-cost) shed decisions
    # verify-at-ingest admission plane (ingest/plane.py):
    # edge sheds per reject class (window deltas; badsig is the flood
    # defense and joins the virtual-mode digest), admitted txs, and the
    # standing per-pod line-rate claim — rejects/sec over the window
    ingest_rejects: Dict[str, int] = field(default_factory=dict)
    ingest_admitted: int = 0
    ingest_flushes: int = 0
    ingest_reject_rate_per_sec: float = 0.0
    # close pipeline (reported, excluded from digest: thread timing)
    pipeline: Dict[str, float] = field(default_factory=dict)
    # SCP signature-scheme plane (reported, excluded from digest: wall
    # timing; the flood A/B reads verify_wall_ms across schemes)
    aggregate: Dict[str, float] = field(default_factory=dict)
    # per-tier aggregates (reported, not digested — the lean-
    # digest policy): for specs that name tiers (core_and_tier shapes),
    # ledger progress and survival-plane counters grouped per tier, so a
    # targeted fault's verdict can read "tier-1 undisturbed, tier-2 shed"
    per_tier: Dict[str, dict] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    @classmethod
    def from_snapshots(
        cls, sim, before: Snapshot, after: Snapshot, exclude_nodes=(),
        tiers=None, **kw
    ):
        """``exclude_nodes``: node hex prefixes excluded from the min-LCL
        liveness computation (a scenario's deliberate straggler must not
        gate the consensus floor it is designed to miss); every other
        counter — and chain agreement — still covers them.  ``tiers``:
        optional {tier_name: set of node hex prefixes} — fills the
        report-only per_tier aggregates."""
        sb = cls(**kw)
        sb.wall_seconds = max(1e-9, after.at - before.at)
        node_deltas = {}
        for node, c1 in after.counters.items():
            c0 = before.counters.get(node, {})
            # a restarted validator is a fresh Application: its counters
            # reset to zero mid-window, so a value below the snapshot
            # means "count since restart" — use it whole, not the
            # (negative) difference
            node_deltas[node] = {
                k: (c1[k] - c0.get(k, 0)) if c1[k] >= c0.get(k, 0)
                else c1[k]
                for k in c1
            }
        deltas = list(node_deltas.values())
        closed = [
            after.lcls[n] - before.lcls.get(n, 0)
            for n in after.lcls
            if n not in exclude_nodes
        ]
        sb.ledgers_closed = min(closed) if closed else 0
        sb.ledgers_per_sec = round(sb.ledgers_closed / sb.wall_seconds, 3)
        for d in deltas:
            sb.nomination_rounds += d["nomination_rounds"]
            sb.ballot_rounds += d["ballot_rounds"]
            sb.envelopes_emitted += d["envelopes_emitted"]
            sb.envelopes_received += d["envelopes_received"]
            sb.flood_fanout += d["flood_fanout"]
            sb.fast_rejects += d["envelopes_invalid_sig"]
            sb.invariant_violations += d["invariant_violations"]
            sb.slip_rejects_past += d.get("slip_rejects_past", 0)
            sb.slip_rejects_future += d.get("slip_rejects_future", 0)
        sb.fast_reject_rate_per_sec = round(
            sb.fast_rejects / sb.wall_seconds, 2
        )
        sb.final_lcls = dict(after.lcls)
        sb.ledgers_agree = sim.all_ledgers_agree()
        if sb.ledgers_agree and sim.nodes:
            from ..ledger.headerframe import LedgerHeaderFrame

            min_seq = min(
                app.ledger_manager.get_last_closed_ledger_num()
                for app in sim.nodes.values()
            )
            any_app = next(iter(sim.nodes.values()))
            f = LedgerHeaderFrame.load_by_sequence(any_app.database, min_seq)
            if f is not None:
                sb.final_hash = f.get_hash().hex()
        # pipeline stats ride the same snapshot-delta discipline as the
        # other counters: stabilization-phase dispatches never count
        # toward the chaos window
        sb.pipeline = {
            k: round(sum(d.get("pipe." + k, 0) for d in deltas), 1)
            for k in _PIPE_KEYS
        }
        sb.aggregate = {
            k: round(sum(d.get("agg." + k, 0) for d in deltas), 1)
            for k in _AGG_KEYS
        }
        for short, key in (
            ("critical", "sendq.shed_critical"),
            ("fetch", "sendq.shed_fetch"),
            ("flood", "sendq.shed_flood"),
            ("gossip", "sendq.shed_gossip"),
        ):
            sb.sendq_sheds[short] = sum(d.get(key, 0) for d in deltas)
        sb.sendq_straggler_disconnects = sum(
            d.get("sendq.stragglers", 0) for d in deltas
        )
        sb.sendq_oversized_admits = sum(
            d.get("sendq.oversized_admits", 0) for d in deltas
        )
        # maxima, not deltas: monotone per node, the AFTER snapshot IS
        # the run's high-water (stabilization traffic never congests)
        sb.sendq_bytes_high_water = max(
            (c.get("sendq.bytes_high_water", 0)
             for c in after.counters.values()),
            default=0,
        )
        sb.sendq_max_stall_ms = round(
            max(
                (c.get("sendq.max_stall_ms", 0.0)
                 for c in after.counters.values()),
                default=0.0,
            ),
            1,
        )
        sb.recv_load_sheds = sum(
            d.get("recv_load_sheds", 0) for d in deltas
        )
        for short, key in (
            ("badsig", "ingest.reject_badsig"),
            ("ratelimit", "ingest.reject_ratelimit"),
            ("surge", "ingest.reject_surge"),
        ):
            sb.ingest_rejects[short] = sum(d.get(key, 0) for d in deltas)
        sb.ingest_admitted = sum(
            d.get("ingest.admitted", 0) for d in deltas
        )
        sb.ingest_flushes = sum(d.get("ingest.flushes", 0) for d in deltas)
        sb.ingest_reject_rate_per_sec = round(
            sum(sb.ingest_rejects.values()) / sb.wall_seconds, 2
        )
        if tiers:
            for tier, members in tiers.items():
                tier_closed = [
                    after.lcls[n] - before.lcls.get(n, 0)
                    for n in after.lcls
                    if n in members
                ]
                td = [d for n, d in node_deltas.items() if n in members]
                tier_min = min(tier_closed) if tier_closed else 0
                sb.per_tier[tier] = {
                    "nodes": len(td),
                    "ledgers_closed": tier_min,
                    "ledgers_per_sec": round(tier_min / sb.wall_seconds, 3),
                    "flood_sheds": sum(
                        d.get("sendq.shed_flood", 0) for d in td
                    ),
                    "critical_sheds": sum(
                        d.get("sendq.shed_critical", 0) for d in td
                    ),
                    "stragglers": sum(
                        d.get("sendq.stragglers", 0) for d in td
                    ),
                    "fast_rejects": sum(
                        d.get("envelopes_invalid_sig", 0) for d in td
                    ),
                    "slip_rejects": sum(
                        d.get("slip_rejects_past", 0)
                        + d.get("slip_rejects_future", 0)
                        for d in td
                    ),
                }
        return sb

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["digest"] = self.digest()
        return d

    def digest(self) -> str:
        """Deterministic-replay oracle: clock-deterministic fields only.
        Virtual-clock scenarios must reproduce this exactly for the same
        (topology, seed, fault program); real-clock scenarios report it
        for the record but rates/wall-time fields stay out regardless."""
        stable = {
            "scenario": self.scenario,
            "seed": self.seed,
            "ledgers_closed": self.ledgers_closed,
            "final_lcls": self.final_lcls,
            "final_hash": self.final_hash,
            "ledgers_agree": self.ledgers_agree,
            "invariant_violations": self.invariant_violations,
        }
        if self.clock_mode == "virtual":
            # deterministic under VIRTUAL_TIME only: counters below move
            # with message/crank interleaving, which the virtual clock
            # replays exactly but a real clock does not
            stable.update(
                wall_seconds=round(self.wall_seconds, 6),
                nomination_rounds=self.nomination_rounds,
                ballot_rounds=self.ballot_rounds,
                fast_rejects=self.fast_rejects,
                recovery_ms=self.recovery_ms,
                # send-side sheds + stragglers are byte- and crank-
                # deterministic; the byte high-water is reported but NOT
                # digested (it depends on per-host frame sizes only
                # through deterministic packing, but keeping the digest
                # lean keeps cross-version replays comparable)
                sendq_sheds=dict(sorted(self.sendq_sheds.items())),
                sendq_stragglers=self.sendq_straggler_disconnects,
                # closeTime-gate rejections are message/crank-order
                # deterministic like fast_rejects (the skew schedules
                # are pure functions of the shared virtual clock)
                slip_rejects_past=self.slip_rejects_past,
                slip_rejects_future=self.slip_rejects_future,
                # ingest-edge sheds ride the same crank-determinism as
                # fast_rejects: injection timers, deadline flushes, and
                # size triggers are pure functions of the virtual clock
                ingest_rejects=dict(sorted(self.ingest_rejects.items())),
            )
        return sha256(
            json.dumps(stable, sort_keys=True).encode()
        ).hex()[:32]
