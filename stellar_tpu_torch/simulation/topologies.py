"""Topologies — canned multi-node network shapes
(reference: src/simulation/Topologies.{h,cpp}).

Each builder returns a ready-but-not-started Simulation; call
``start_all_nodes`` then ``crank_until(have_all_externalized...)``.
"""

from __future__ import annotations

from typing import List, Optional

from ..crypto.keys import SecretKey
from ..util import VirtualClock
from ..xdr.scp import SCPQuorumSet
from .simulation import OVER_LOOPBACK, Simulation


def _keys(n: int) -> List[SecretKey]:
    return [SecretKey.pseudo_random_for_testing(i + 1) for i in range(n)]


def pair(mode: str = OVER_LOOPBACK, clock: Optional[VirtualClock] = None) -> Simulation:
    """Two validators, each requiring both (Topologies::pair)."""
    sim = Simulation(mode, clock)
    k = _keys(2)
    qset = SCPQuorumSet(2, [x.get_public_key() for x in k], [])
    for x in k:
        sim.add_node(x, qset)
    sim.add_pending_connection(k[0], k[1])
    return sim


def cycle4(clock: Optional[VirtualClock] = None) -> Simulation:
    """4 nodes in a ring; each trusts itself + next (threshold 2 of 2) —
    the reference's pathological-but-live shape (Topologies::cycle4)."""
    sim = Simulation(OVER_LOOPBACK, clock)
    k = _keys(4)
    for i, x in enumerate(k):
        nxt = k[(i + 1) % 4]
        qset = SCPQuorumSet(
            2, [x.get_public_key(), nxt.get_public_key()], []
        )
        sim.add_node(x, qset)
    for i in range(4):
        sim.add_pending_connection(k[i], k[(i + 1) % 4])
    # cross links like the reference (0-2, 1-3)
    sim.add_pending_connection(k[0], k[2])
    sim.add_pending_connection(k[1], k[3])
    return sim


def core(
    n: int,
    threshold: Optional[int] = None,
    mode: str = OVER_LOOPBACK,
    clock: Optional[VirtualClock] = None,
) -> Simulation:
    """Fully connected core of n validators sharing one quorum set
    (Topologies::core)."""
    sim = Simulation(mode, clock)
    k = _keys(n)
    if threshold is None:
        threshold = n - (n - 1) // 3  # BFT majority
    qset = SCPQuorumSet(threshold, [x.get_public_key() for x in k], [])
    for x in k:
        sim.add_node(x, qset)
    for i in range(n):
        for j in range(i + 1, n):
            sim.add_pending_connection(k[i], k[j])
    return sim


def hierarchical_quorum_simplified(
    core_n: int = 4,
    outer_n: int = 2,
    clock: Optional[VirtualClock] = None,
) -> Simulation:
    """A core plus outer validators whose quorum slice is the core
    (Topologies::hierarchicalQuorumSimplified)."""
    sim = Simulation(OVER_LOOPBACK, clock)
    ck = _keys(core_n)
    core_threshold = core_n - (core_n - 1) // 3
    core_qset = SCPQuorumSet(core_threshold, [x.get_public_key() for x in ck], [])
    for x in ck:
        sim.add_node(x, core_qset)
    for i in range(core_n):
        for j in range(i + 1, core_n):
            sim.add_pending_connection(ck[i], ck[j])
    ok = [SecretKey.pseudo_random_for_testing(100 + i) for i in range(outer_n)]
    for i, x in enumerate(ok):
        # outer node: itself + the whole core as inner set
        qset = SCPQuorumSet(2, [x.get_public_key()], [core_qset])
        sim.add_node(x, qset)
        sim.add_pending_connection(x, ck[i % core_n])
    return sim


def core_and_tier(
    core_n: int = 4,
    tier_n: int = 4,
    clock: Optional[VirtualClock] = None,
    cfg_factory=None,
    mode: str = OVER_LOOPBACK,
    tier_validators: bool = True,
) -> Simulation:
    """Core-and-tier quorum ring (SURVEY §2.11; the chaos plane's default
    big shape): a fully-meshed core of ``core_n`` validators sharing one
    BFT-majority quorum set, plus a RING of ``tier_n`` tier-2 validators —
    each tier node's quorum slice is {threshold 2: [self, inner: core]}
    (itself plus a core quorum, the hierarchicalQuorumSimplified outer
    shape) and its links are its two ring neighbors plus one core node.
    Consensus must traverse the ring through the core, so partitions that
    cut ring chords exercise multi-hop flood relay.

    ``tier_validators=False`` makes every tier node a WATCHER (tracks and
    relays, never nominates) — the committee-plus-relays shape: at 100+
    nodes a hundred independent nominators churn nomination for minutes
    per slot, while a 4-core committee with 96 relaying watchers closes
    at cadence and still drives the full fan-out/sendqueue surface (the
    committee-based-consensus framing of arXiv:2302.00418).

    The ring is deliberately RELAY-ONLY, not a trust edge: the old
    slice {threshold 2: [self, ring-successor], inner: core} made any
    ring cycle SELF-QUORATE — the targeted_flood_tier2 chaos class
    proved a flood-isolated tier pair would externalize its own values
    and fork from the core (safety, not just liveness).  With the core
    required in every tier slice, an isolated tier can only stall and
    recover, never fork.

    ``cfg_factory(i)`` (optional) supplies each node's Config — the
    scenario runner uses it to pin disk DBs / archives; ``i`` counts core
    nodes first, then tier nodes.  ``mode=OVER_TCP`` wires the same shape
    over real localhost sockets (the 100+ node scale scenario
    — the fault knobs stay loopback-only, but load/flood node APIs and
    the sendqueue/fan-out planes run against the production transport)."""
    sim = Simulation(mode, clock)
    ck = _keys(core_n)
    core_threshold = core_n - (core_n - 1) // 3
    core_qset = SCPQuorumSet(
        core_threshold, [x.get_public_key() for x in ck], []
    )
    for i, x in enumerate(ck):
        sim.add_node(
            x, core_qset,
            cfg=cfg_factory(i) if cfg_factory is not None else None,
        )
    for i in range(core_n):
        for j in range(i + 1, core_n):
            sim.add_pending_connection(ck[i], ck[j])
    tk = [
        SecretKey.pseudo_random_for_testing(300 + i) for i in range(tier_n)
    ]
    for i, x in enumerate(tk):
        qset = SCPQuorumSet(
            2,
            [x.get_public_key()],
            [core_qset],
        )
        sim.add_node(
            x, qset,
            cfg=(
                cfg_factory(core_n + i) if cfg_factory is not None else None
            ),
            validator=tier_validators,
        )
    for i in range(tier_n):
        sim.add_pending_connection(tk[i], tk[(i + 1) % tier_n])
        sim.add_pending_connection(tk[i], ck[i % core_n])
    # remember construction order for callers that index nodes (the
    # scenario runner's fault programs name nodes by index)
    sim.topology_keys = ck + tk
    return sim


def hierarchical_quorum(
    n_branches: int = 2,
    clock: Optional[VirtualClock] = None,
) -> Simulation:
    """Full nested hierarchicalQuorum — 'Figure 3 from the paper'
    (Topologies::hierarchicalQuorum, Topologies.cpp:114-176): a 4-node core
    (threshold 3) plus ``n_branches`` middle-tier validators, each with the
    NESTED quorum set {threshold 2: [self, {threshold 2: core}]} — the only
    topology that exercises inner-set evaluation in live consensus."""
    sim = Simulation(OVER_LOOPBACK, clock)
    ck = _keys(4)
    core_qset = SCPQuorumSet(3, [x.get_public_key() for x in ck], [])
    for x in ck:
        sim.add_node(x, core_qset)
    for i in range(4):
        for j in range(i + 1, 4):
            sim.add_pending_connection(ck[i], ck[j])
    top_tier = SCPQuorumSet(2, [x.get_public_key() for x in ck], [])
    for i in range(n_branches):
        mk = SecretKey.pseudo_random_for_testing(200 + i)
        # self + any 2 from the top tier, as a nested inner set
        qset = SCPQuorumSet(2, [mk.get_public_key()], [top_tier])
        sim.add_node(mk, qset)
        for c in ck:
            sim.add_pending_connection(mk, c)
    return sim
