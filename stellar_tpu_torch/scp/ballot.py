"""Ballot protocol: prepare → confirm → externalize federated voting
(reference: src/scp/BallotProtocol.{h,cpp}).

State per slot (the SCP whitepaper's variables):
  b  = ``current``            working ballot
  p  = ``prepared``           highest accepted-prepared ballot
  p' = ``prepared_prime``     highest accepted-prepared incompatible with p
  P  = ``confirmed_prepared`` highest confirmed-prepared ballot (a.k.a. h)
  c  = ``commit``             lowest ballot we are trying to commit

A ballot (n, x) is totally ordered by (counter, value); ballots are
*compatible* when their values match.  CONFIRM is modeled as PREPARE with an
infinite counter, EXTERNALIZE as CONFIRM forever — which is why ``current``
jumps to counter=UINT32_MAX on entering the confirm phase.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..xdr.scp import (
    SCPBallot,
    SCPEnvelope,
    SCPStatement,
    SCPStatementConfirm,
    SCPStatementExternalize,
    SCPStatementPledges,
    SCPStatementPrepare,
    SCPStatementType,
)
from ..xdr.xtypes import NodeID
from . import quorum
from .driver import EnvelopeState

UINT32_MAX = 0xFFFFFFFF

# a single received message may cascade state transitions; bound the recursion
MAX_ADVANCE_SLOT_RECURSION = 50

ST = SCPStatementType


class Phase(enum.Enum):
    PREPARE = 0
    CONFIRM = 1
    EXTERNALIZE = 2


# -- ballot arithmetic ------------------------------------------------------


def cmp_ballots(b1: Optional[SCPBallot], b2: Optional[SCPBallot]) -> int:
    """Total order: None < everything; then (counter, value) lexicographic."""
    if b1 is None or b2 is None:
        return (b1 is not None) - (b2 is not None)
    if b1.counter != b2.counter:
        return -1 if b1.counter < b2.counter else 1
    if b1.value != b2.value:
        return -1 if b1.value < b2.value else 1
    return 0


def compatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return b1.value == b2.value


def less_and_incompatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return cmp_ballots(b1, b2) <= 0 and not compatible(b1, b2)


def less_and_compatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return cmp_ballots(b1, b2) <= 0 and compatible(b1, b2)


def working_ballot(st: SCPStatement) -> SCPBallot:
    """The ballot a statement is 'about' (BallotProtocol.cpp:1243-1263)."""
    pl = st.pledges
    if pl.type == ST.SCP_ST_PREPARE:
        return pl.prepare.ballot
    if pl.type == ST.SCP_ST_CONFIRM:
        return SCPBallot(pl.confirm.nPrepared, pl.confirm.commit.value)
    return pl.externalize.commit


def _statement_prepared_ballot(st: SCPStatement) -> Optional[SCPBallot]:
    """What `st` pledges as its highest prepared ballot, if any."""
    pl = st.pledges
    if pl.type == ST.SCP_ST_PREPARE:
        return pl.prepare.prepared
    if pl.type == ST.SCP_ST_CONFIRM:
        return SCPBallot(pl.confirm.nPrepared, pl.confirm.commit.value)
    return None  # EXTERNALIZE handled specially (infinite counter)


def statement_pledges_prepared(ballot: SCPBallot, st: SCPStatement) -> bool:
    """Does `st` claim `ballot` (or a bigger compatible one) prepared?"""
    pl = st.pledges
    if pl.type == ST.SCP_ST_EXTERNALIZE:
        return compatible(ballot, pl.externalize.commit)
    p = _statement_prepared_ballot(st)
    return p is not None and less_and_compatible(ballot, p)


Interval = Tuple[int, int]


def _commit_interval_pred(ballot: SCPBallot, check: Interval, st: SCPStatement) -> bool:
    """Does `st` pledge commit for every counter in `check` on ballots
    compatible with `ballot`? (BallotProtocol.cpp:817-849)"""
    pl = st.pledges
    if pl.type == ST.SCP_ST_CONFIRM:
        c = pl.confirm
        return compatible(ballot, c.commit) and c.commit.counter <= check[0] and check[1] <= c.nP
    if pl.type == ST.SCP_ST_EXTERNALIZE:
        e = pl.externalize
        return compatible(ballot, e.commit) and e.commit.counter <= check[0] and check[1] <= e.nP
    return False


def find_extended_interval(
    candidate: Interval, boundaries: Set[Interval], pred: Callable[[Interval], bool]
) -> Interval:
    """Greedily grow [low, high] over the sorted boundary counters while
    `pred` holds (BallotProtocol.cpp:893-934).  candidate==(0,0) means
    'not found yet'."""
    values = sorted({v for seg in boundaries for v in seg})
    for b in values:
        if candidate[0] == 0:
            cur = (b, b)
        elif b < candidate[1]:
            continue
        else:
            cur = (candidate[0], b)
        if pred(cur):
            candidate = cur
        elif candidate[0] != 0:
            break  # could not extend further
    return candidate


# -- the protocol -----------------------------------------------------------


class BallotProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.phase = Phase.PREPARE
        self.current: Optional[SCPBallot] = None
        self.prepared: Optional[SCPBallot] = None
        self.prepared_prime: Optional[SCPBallot] = None
        self.confirmed_prepared: Optional[SCPBallot] = None
        self.commit: Optional[SCPBallot] = None
        self.latest_envelopes: Dict[NodeID, SCPEnvelope] = {}
        self.last_envelope: Optional[SCPEnvelope] = None
        self.heard_from_quorum = True
        self._message_level = 0

    # -- message ordering ---------------------------------------------------
    @staticmethod
    def is_newer_statement(old: SCPStatement, st: SCPStatement) -> bool:
        """Total order on ballot statements: by type, then by the
        whitepaper's (b, p, p', P) lexicographic order within a type."""
        to, tn = old.pledges.type, st.pledges.type
        if to != tn:
            return to < tn
        if tn == ST.SCP_ST_EXTERNALIZE:
            return False  # a node externalizes exactly once
        if tn == ST.SCP_ST_CONFIRM:
            oc, nc = old.pledges.confirm, st.pledges.confirm
            if oc.nPrepared != nc.nPrepared:
                return oc.nPrepared < nc.nPrepared
            return oc.nP < nc.nP
        op, np_ = old.pledges.prepare, st.pledges.prepare
        for a, b in (
            (op.ballot, np_.ballot),
            (op.prepared, np_.prepared),
            (op.preparedPrime, np_.preparedPrime),
        ):
            c = cmp_ballots(a, b)
            if c != 0:
                return c < 0
        return op.nP < np_.nP

    def _is_newer_from(self, node_id: NodeID, st: SCPStatement) -> bool:
        old = self.latest_envelopes.get(node_id)
        return old is None or self.is_newer_statement(old.statement, st)

    # -- sanity -------------------------------------------------------------
    def _is_statement_sane(self, st: SCPStatement) -> bool:
        qset = self.slot.quorum_set_from_statement(st)
        if qset is None or not self.slot.scp.is_qset_sane_for(st.nodeID, qset):
            return False
        pl = st.pledges
        if pl.type == ST.SCP_ST_PREPARE:
            p = pl.prepare
            ok = p.ballot.counter > 0
            ok = ok and (p.prepared is None or p.ballot.counter >= p.prepared.counter)
            ok = ok and (
                p.preparedPrime is None
                or p.prepared is None
                or less_and_incompatible(p.preparedPrime, p.prepared)
            )
            ok = ok and (p.nP == 0 or (p.prepared is not None and p.nP <= p.prepared.counter))
            ok = ok and (p.nC == 0 or (p.nP != 0 and p.nP >= p.nC))
            return ok
        if pl.type == ST.SCP_ST_CONFIRM:
            c = pl.confirm
            return 0 < c.commit.counter <= c.nP
        e = pl.externalize
        return 0 < e.commit.counter <= e.nP

    # -- entry point ---------------------------------------------------------
    def process_envelope(self, envelope: SCPEnvelope) -> EnvelopeState:
        st = envelope.statement
        assert st.slotIndex == self.slot.index

        if not self._is_statement_sane(st):
            return EnvelopeState.INVALID
        if not self._is_newer_from(st.nodeID, st):
            return EnvelopeState.INVALID

        wb = working_ballot(st)
        if not self.slot.driver.validate_value(self.slot.index, wb.value):
            return EnvelopeState.INVALID

        if self.phase != Phase.EXTERNALIZE:
            tick = wb
            if st.pledges.type != ST.SCP_ST_PREPARE:
                # CONFIRM/EXTERNALIZE speak for every counter above their
                # own: tick at least our working counter so old statements
                # still drive progress at the current round
                mine = (
                    (self.current.counter if self.current else 0)
                    if self.phase == Phase.PREPARE
                    else self.prepared.counter
                )
                if tick.counter < mine:
                    tick = SCPBallot(mine, tick.value)
            self._record_envelope(envelope)
            self.advance_slot(tick)
            return EnvelopeState.VALID

        # externalized: accept only statements about the chosen value —
        # including our own final EXTERNALIZE
        if compatible(self.commit, wb):
            self._record_envelope(envelope)
            return EnvelopeState.VALID
        return EnvelopeState.INVALID

    def _record_envelope(self, env: SCPEnvelope) -> None:
        self.latest_envelopes[env.statement.nodeID] = env
        self.slot.record_statement(env.statement)

    # -- local-state transitions ---------------------------------------------
    def abandon_ballot(self) -> bool:
        v = self.slot.latest_composite_candidate()
        if not v:
            if self.current is None:
                return False
            v = self.current.value
        return self.bump_state(v, force=True)

    def bump_state(self, value: bytes, force: bool) -> bool:
        if self.phase != Phase.PREPARE:
            return False
        if not force and self.current is not None:
            return False
        if self.confirmed_prepared is not None:
            # locked on a value already: only the counter may move
            newb = SCPBallot(self.current.counter + 1, self.confirmed_prepared.value)
        else:
            newb = SCPBallot(self.current.counter + 1 if self.current else 1, value)
        updated = self._update_current_value(newb)
        if updated:
            self.slot.driver.started_ballot_protocol(self.slot.index, newb)
            self._emit_current_state()
        return updated

    def _update_current_value(self, ballot: SCPBallot) -> bool:
        if self.phase != Phase.PREPARE:
            return False
        if self.current is None:
            self._bump_to_ballot(ballot)
            return True
        if self.commit is not None and not compatible(self.commit, ballot):
            return False
        comp = cmp_ballots(self.current, ballot)
        if comp < 0:
            self._bump_to_ballot(ballot)
            return True
        # comp > 0 would mean regressing to a smaller ballot — peers not
        # following protocol; refuse (BallotProtocol.cpp:407-424)
        return False

    def _bump_to_ballot(self, ballot: SCPBallot) -> None:
        assert self.phase != Phase.EXTERNALIZE
        assert self.current is None or cmp_ballots(ballot, self.current) >= 0
        got_bumped = self.current is None or self.current.counter != ballot.counter
        self.current = SCPBallot(ballot.counter, ballot.value)
        self.heard_from_quorum = False
        if got_bumped:
            self._start_timer()

    def _start_timer(self) -> None:
        from .slot import BALLOT_PROTOCOL_TIMER

        timeout = self.slot.driver.compute_timeout(self.current.counter)
        self.slot.driver.setup_timer(
            self.slot.index, BALLOT_PROTOCOL_TIMER, timeout, self._timer_expired
        )

    def _timer_expired(self) -> None:
        # don't abandon the ballot until a full slice has spoken at this round
        if self.heard_from_quorum:
            self.abandon_ballot()
        else:
            self._start_timer()

    # -- statement construction ----------------------------------------------
    def _create_statement(self) -> SCPStatement:
        self._check_invariants()
        qsh = self.slot.local_qset_hash()
        if self.phase == Phase.PREPARE:
            pledges = SCPStatementPledges(
                ST.SCP_ST_PREPARE,
                SCPStatementPrepare(
                    quorumSetHash=qsh,
                    ballot=self.current,
                    prepared=self.prepared,
                    preparedPrime=self.prepared_prime,
                    nC=self.commit.counter if self.commit else 0,
                    nP=self.confirmed_prepared.counter if self.confirmed_prepared else 0,
                ),
            )
        elif self.phase == Phase.CONFIRM:
            assert self.current.counter == UINT32_MAX
            pledges = SCPStatementPledges(
                ST.SCP_ST_CONFIRM,
                SCPStatementConfirm(
                    quorumSetHash=qsh,
                    nPrepared=self.prepared.counter,
                    commit=self.commit,
                    nP=self.confirmed_prepared.counter,
                ),
            )
        else:
            assert self.current.counter == UINT32_MAX
            pledges = SCPStatementPledges(
                ST.SCP_ST_EXTERNALIZE,
                SCPStatementExternalize(
                    commit=self.commit,
                    nP=self.confirmed_prepared.counter,
                    commitQuorumSetHash=qsh,
                ),
            )
        return SCPStatement(nodeID=self.slot.local_node_id(), slotIndex=self.slot.index, pledges=pledges)

    def _emit_current_state(self) -> None:
        envelope = self.slot.create_envelope(self._create_statement())
        if self.slot.process_envelope(envelope) != EnvelopeState.VALID:
            # queueing a statement we ourselves consider invalid is a bug
            raise RuntimeError("ballot protocol moved to a bad state")
        if self.last_envelope is None or self.is_newer_statement(
            self.last_envelope.statement, envelope.statement
        ):
            self.last_envelope = envelope
            self.slot.driver.emit_envelope(envelope)

    def _check_invariants(self) -> None:
        if self.current is not None:
            assert self.current.counter != 0
        if self.prepared is not None and self.prepared_prime is not None:
            assert less_and_incompatible(self.prepared_prime, self.prepared)
        if self.commit is not None:
            assert less_and_compatible(self.commit, self.confirmed_prepared)
            assert less_and_compatible(self.confirmed_prepared, self.current)
        if self.phase == Phase.CONFIRM:
            assert self.commit is not None
        elif self.phase == Phase.EXTERNALIZE:
            assert self.commit is not None and self.confirmed_prepared is not None

    # -- step 0: bump with the network --------------------------------------
    def _attempt_bump(self, ballot: SCPBallot) -> bool:
        """If a v-blocking set moved past our counter, time out and follow
        (BallotProtocol.cpp:628-669 attemptPrepare)."""
        if self.phase != Phase.PREPARE:
            return False

        def moved_past(st: SCPStatement) -> bool:
            pl = st.pledges
            if pl.type == ST.SCP_ST_PREPARE:
                return self.current is None or self.current.counter < pl.prepare.ballot.counter
            cm = pl.confirm.commit if pl.type == ST.SCP_ST_CONFIRM else pl.externalize.commit
            return self.confirmed_prepared is not None and less_and_compatible(
                self.confirmed_prepared, cm
            )

        if quorum.is_v_blocking_with(self.slot.local_qset(), self.latest_envelopes, moved_past):
            return self.abandon_ballot()
        return False

    # -- step 1: accept prepared ---------------------------------------------
    def _is_prepared_accept(self, ballot: SCPBallot) -> bool:
        if self.phase == Phase.EXTERNALIZE:
            return False
        if self.phase == Phase.CONFIRM:
            # only interesting if it extends the prepared interval
            if not less_and_compatible(self.prepared, ballot):
                return False
            assert compatible(self.commit, ballot)
        if self.prepared is not None and cmp_ballots(ballot, self.prepared) == 0:
            return False

        def votes_for(st: SCPStatement) -> bool:
            pl = st.pledges
            if pl.type == ST.SCP_ST_PREPARE:
                return cmp_ballots(ballot, pl.prepare.ballot) == 0
            if pl.type == ST.SCP_ST_CONFIRM:
                return compatible(ballot, pl.confirm.commit)
            return compatible(ballot, pl.externalize.commit)

        return self.slot.federated_accept(
            votes_for, lambda st: statement_pledges_prepared(ballot, st), self.latest_envelopes
        )

    def _attempt_prepared_accept(self, ballot: SCPBallot) -> bool:
        did_work = False
        # a newly prepared ballot is also a chance to bump b right away
        if self.current is None:
            self._bump_to_ballot(ballot)
            did_work = True
        elif self.phase == Phase.PREPARE and cmp_ballots(self.current, ballot) < 0:
            self._bump_to_ballot(ballot)
            did_work = True

        did_work = self._set_prepared(ballot) or did_work

        # abort c if p/p' now invalidates the commit range
        if self.commit is not None and self.confirmed_prepared is not None:
            if (
                self.prepared is not None
                and less_and_incompatible(self.confirmed_prepared, self.prepared)
            ) or (
                self.prepared_prime is not None
                and less_and_incompatible(self.confirmed_prepared, self.prepared_prime)
            ):
                assert self.phase == Phase.PREPARE
                self.commit = None
                did_work = True

        if did_work:
            self.slot.driver.accepted_ballot_prepared(self.slot.index, ballot)
            self._emit_current_state()
        return did_work

    def _set_prepared(self, ballot: SCPBallot) -> bool:
        if self.prepared is None:
            self.prepared = ballot
            return True
        if cmp_ballots(self.prepared, ballot) < 0:
            if not compatible(self.prepared, ballot):
                self.prepared_prime = self.prepared
            self.prepared = ballot
            return True
        return False

    # -- step 2: confirm prepared --------------------------------------------
    def _is_prepared_confirmed(self, ballot: SCPBallot) -> bool:
        if self.phase != Phase.PREPARE or self.prepared is None:
            return False
        if (
            self.confirmed_prepared is not None
            and cmp_ballots(self.confirmed_prepared, ballot) >= 0
        ):
            return False
        return self.slot.federated_ratify(
            lambda st: statement_pledges_prepared(ballot, st), self.latest_envelopes
        )

    def _attempt_prepared_confirmed(self, ballot: SCPBallot) -> bool:
        did_work = False
        if self.confirmed_prepared is None or cmp_ballots(self.confirmed_prepared, ballot) != 0:
            self.confirmed_prepared = ballot
            did_work = True
        # maybe start committing: c <- P when P caught up with b and the
        # commit range is not aborted by p/p'
        if self.commit is None and cmp_ballots(self.confirmed_prepared, self.current) >= 0:
            if not less_and_incompatible(self.confirmed_prepared, self.prepared) or (
                self.prepared_prime is not None
                and not less_and_incompatible(self.confirmed_prepared, self.prepared_prime)
            ):
                self.current = ballot
                self.commit = ballot
                did_work = True
        if did_work:
            self.slot.driver.confirmed_ballot_prepared(self.slot.index, ballot)
            self._emit_current_state()
        return did_work

    # -- steps 3/4: accept & confirm commit ------------------------------------
    def _commit_boundaries(self, ballot: SCPBallot) -> Set[Interval]:
        res: Set[Interval] = set()
        for env in self.latest_envelopes.values():
            pl = env.statement.pledges
            if pl.type == ST.SCP_ST_PREPARE:
                p = pl.prepare
                if compatible(ballot, p.ballot) and p.nC:
                    res.add((p.nC, p.nP))
            elif pl.type == ST.SCP_ST_CONFIRM:
                c = pl.confirm
                if compatible(ballot, c.commit):
                    res.add((c.commit.counter, c.nP))
            else:
                e = pl.externalize
                if compatible(ballot, e.commit):
                    res.add((e.commit.counter, UINT32_MAX))
        return res

    def _is_accept_commit(self, ballot: SCPBallot) -> Optional[Tuple[SCPBallot, SCPBallot]]:
        if self.phase == Phase.EXTERNALIZE:
            return None
        if self.phase == Phase.CONFIRM and not compatible(ballot, self.confirmed_prepared):
            return None

        def votes_commit(st: SCPStatement, cur: Interval) -> bool:
            pl = st.pledges
            if pl.type == ST.SCP_ST_PREPARE:
                p = pl.prepare
                return (
                    compatible(ballot, p.ballot)
                    and p.nC != 0
                    and p.nC <= cur[0]
                    and cur[1] <= p.nP
                )
            if pl.type == ST.SCP_ST_CONFIRM:
                c = pl.confirm
                return compatible(ballot, c.commit) and c.commit.counter <= cur[0]
            e = pl.externalize
            return compatible(ballot, e.commit) and e.commit.counter <= cur[0]

        def pred(cur: Interval) -> bool:
            return self.slot.federated_accept(
                lambda st: votes_commit(st, cur),
                lambda st: _commit_interval_pred(ballot, cur, st),
                self.latest_envelopes,
            )

        boundaries = self._commit_boundaries(ballot)
        candidate: Interval = (0, 0)
        if self.phase == Phase.CONFIRM:
            # can only extend the upper end of the accepted range
            candidate = (self.commit.counter, self.confirmed_prepared.counter)
            boundaries = {b for b in boundaries if b[1] > self.confirmed_prepared.counter}
        if not boundaries:
            return None
        candidate = find_extended_interval(candidate, boundaries, pred)
        if candidate[0] == 0:
            return None
        if self.phase == Phase.CONFIRM and candidate[1] <= self.confirmed_prepared.counter:
            return None
        return (SCPBallot(candidate[0], ballot.value), SCPBallot(candidate[1], ballot.value))

    def _attempt_accept_commit(self, low: SCPBallot, high: SCPBallot) -> bool:
        if self.phase != Phase.PREPARE and not less_and_compatible(self.confirmed_prepared, high):
            return False
        self.commit = low
        self.confirmed_prepared = high
        # from here on the counter is infinite: we pledge to commit forever
        self.current = SCPBallot(UINT32_MAX, high.value)
        self._set_prepared(high)
        self.phase = Phase.CONFIRM
        self.slot.driver.accepted_commit(self.slot.index, high)
        self._emit_current_state()
        return True

    def _is_confirm_commit(self, ballot: SCPBallot) -> Optional[Tuple[SCPBallot, SCPBallot]]:
        if self.phase != Phase.CONFIRM:
            return None
        if not compatible(ballot, self.commit):
            return None

        def pred(cur: Interval) -> bool:
            return self.slot.federated_ratify(
                lambda st: _commit_interval_pred(ballot, cur, st), self.latest_envelopes
            )

        candidate = find_extended_interval((0, 0), self._commit_boundaries(ballot), pred)
        if candidate[0] == 0:
            return None
        return (SCPBallot(candidate[0], ballot.value), SCPBallot(candidate[1], ballot.value))

    def _attempt_confirm_commit(self, low: SCPBallot, high: SCPBallot) -> bool:
        self.commit = low
        self.confirmed_prepared = high
        self.phase = Phase.EXTERNALIZE
        self._emit_current_state()
        self.slot.driver.value_externalized(self.slot.index, self.current.value)
        return True

    # -- the step sequencer ---------------------------------------------------
    def advance_slot(self, ballot: SCPBallot) -> None:
        self._message_level += 1
        if self._message_level >= MAX_ADVANCE_SLOT_RECURSION:
            self._message_level -= 1
            raise RuntimeError("maximum number of transitions reached in advance_slot")

        self._maybe_hear_from_quorum()

        try:
            # whitepaper step order; stop at the first transition that did
            # work (its emit re-enters advance_slot to run the rest)
            if self._is_prepared_accept(ballot) and self._attempt_prepared_accept(ballot):
                return
            if self._is_prepared_confirmed(ballot) and self._attempt_prepared_confirmed(ballot):
                return
            lh = self._is_accept_commit(ballot)
            if lh is not None and self._attempt_accept_commit(*lh):
                return
            lh = self._is_confirm_commit(ballot)
            if lh is not None and self._attempt_confirm_commit(*lh):
                return
            # nothing else to do: maybe the network moved on without us
            self._attempt_bump(ballot)
        finally:
            self._message_level -= 1

    def _maybe_hear_from_quorum(self) -> None:
        if self.heard_from_quorum or self.current is None:
            return

        def at_our_round(st: SCPStatement) -> bool:
            if st.pledges.type == ST.SCP_ST_PREPARE:
                return self.current.counter <= st.pledges.prepare.ballot.counter
            return True

        if quorum.is_quorum_with(
            self.slot.local_qset(),
            self.latest_envelopes,
            self.slot.quorum_set_from_statement,
            at_our_round,
        ):
            self.heard_from_quorum = True
            self.slot.driver.ballot_did_hear_from_quorum(self.slot.index, self.current)

    # -- restart-from-disk -----------------------------------------------------
    def set_state_from_envelope(self, e: SCPEnvelope) -> None:
        if self.current is not None:
            raise RuntimeError("cannot set state after starting ballot protocol")
        self._record_envelope(e)
        self.last_envelope = e
        pl = e.statement.pledges
        if pl.type == ST.SCP_ST_PREPARE:
            p = pl.prepare
            self._bump_to_ballot(p.ballot)
            self.prepared = p.prepared
            self.prepared_prime = p.preparedPrime
            if p.nP:
                self.confirmed_prepared = SCPBallot(p.nP, p.ballot.value)
            if p.nC:
                self.commit = SCPBallot(p.nC, p.ballot.value)
            self.phase = Phase.PREPARE
        elif pl.type == ST.SCP_ST_CONFIRM:
            c = pl.confirm
            v = c.commit.value
            self._bump_to_ballot(SCPBallot(UINT32_MAX, v))
            self.prepared = SCPBallot(c.nPrepared, v)
            self.confirmed_prepared = SCPBallot(c.nP, v)
            self.commit = c.commit
            self.phase = Phase.CONFIRM
        else:
            x = pl.externalize
            v = x.commit.value
            self._bump_to_ballot(SCPBallot(UINT32_MAX, v))
            self.prepared = SCPBallot(UINT32_MAX, v)
            self.confirmed_prepared = SCPBallot(x.nP, v)
            self.commit = x.commit
            self.phase = Phase.EXTERNALIZE

    def get_current_state(self) -> List[SCPEnvelope]:
        return list(self.latest_envelopes.values())

    def dump_info(self) -> dict:
        b2s = lambda b: None if b is None else {"n": b.counter, "x": b.value.hex()[:12]}
        return {
            "phase": self.phase.name,
            "heard": self.heard_from_quorum,
            "b": b2s(self.current),
            "p": b2s(self.prepared),
            "p'": b2s(self.prepared_prime),
            "P": b2s(self.confirmed_prepared),
            "c": b2s(self.commit),
            "M": len(self.latest_envelopes),
        }
