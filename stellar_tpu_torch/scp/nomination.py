"""Nomination protocol: converge on a set of candidate values
(reference: src/scp/NominationProtocol.{h,cpp}).

Round-based: each round deterministically elects leader(s) by weighted hash
(priority = H(slot, prev, 'P', round, node) when the node wins its
neighborhood lottery H(...,'N',...) < weight); non-leaders echo the leaders'
votes.  Votes are promoted vote → accepted (federated accept) → candidate
(federated ratify); candidates are combined by the driver and handed to the
ballot protocol.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..xdr.scp import (
    SCPEnvelope,
    SCPNomination,
    SCPStatement,
    SCPStatementPledges,
    SCPStatementType,
)
from ..xdr.xtypes import NodeID
from . import quorum
from .driver import EnvelopeState

ST = SCPStatementType


def _is_subset(p: List[bytes], v: List[bytes]):
    """(is_subset, grew): both lists are sorted per is_sane."""
    if len(p) > len(v):
        return False, True
    vs = set(v)
    if all(x in vs for x in p):
        return True, len(p) != len(v)
    return False, True


def is_newer_nomination(old: SCPNomination, new: SCPNomination) -> bool:
    """Newer iff votes and accepted are both supersets and at least one grew."""
    ok_v, grew_v = _is_subset(old.votes, new.votes)
    if not ok_v:
        return False
    ok_a, grew_a = _is_subset(old.accepted, new.accepted)
    return ok_a and (grew_v or grew_a)


class NominationProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.round_number = 0
        self.started = False
        self.previous_value = b""
        self.votes: Set[bytes] = set()  # X
        self.accepted: Set[bytes] = set()  # Y
        self.candidates: Set[bytes] = set()  # Z
        self.latest_nominations: Dict[NodeID, SCPEnvelope] = {}
        self.latest_composite: bytes = b""
        self.round_leaders: Set[NodeID] = set()
        self.last_envelope: Optional[SCPEnvelope] = None

    # -- leader election ------------------------------------------------------
    def _node_priority(self, node_id: NodeID, qset) -> int:
        d = self.slot.driver
        w = quorum.node_weight(node_id, qset)
        if (
            d.compute_hash_node(
                self.slot.index, self.previous_value, False, self.round_number, node_id
            )
            < w
        ):
            return d.compute_hash_node(
                self.slot.index, self.previous_value, True, self.round_number, node_id
            )
        return 0

    def _update_round_leaders(self) -> None:
        qset = self.slot.local_qset()
        self.round_leaders = set()
        top = 0
        for node in quorum.iter_all_nodes(qset):
            w = self._node_priority(node, qset)
            if w > top:
                top = w
                self.round_leaders = set()
            if w == top and w > 0:
                self.round_leaders.add(node)

    # -- statement plumbing ----------------------------------------------------
    def _is_newer_from(self, node_id: NodeID, nom: SCPNomination) -> bool:
        old = self.latest_nominations.get(node_id)
        return old is None or is_newer_nomination(old.statement.pledges.nominate, nom)

    def _is_sane(self, st: SCPStatement) -> bool:
        nom = st.pledges.nominate
        if not nom.votes and not nom.accepted:
            return False
        if sorted(nom.votes) != list(nom.votes) or sorted(nom.accepted) != list(nom.accepted):
            return False
        qset = self.slot.quorum_set_from_statement(st)
        return qset is not None and self.slot.scp.is_qset_sane_for(
            st.nodeID, qset
        )

    def _record_envelope(self, env: SCPEnvelope) -> None:
        self.latest_nominations[env.statement.nodeID] = env
        self.slot.record_statement(env.statement)

    def _emit_nomination(self) -> None:
        st = SCPStatement(
            nodeID=self.slot.local_node_id(),
            slotIndex=self.slot.index,
            pledges=SCPStatementPledges(
                ST.SCP_ST_NOMINATE,
                SCPNomination(
                    quorumSetHash=self.slot.local_qset_hash(),
                    votes=sorted(self.votes),
                    accepted=sorted(self.accepted),
                ),
            ),
        )
        envelope = self.slot.create_envelope(st)
        if self.slot.process_envelope(envelope) != EnvelopeState.VALID:
            raise RuntimeError("nomination moved to a bad state")
        if self.last_envelope is None or is_newer_nomination(
            self.last_envelope.statement.pledges.nominate, st.pledges.nominate
        ):
            self.last_envelope = envelope
            self.slot.driver.emit_envelope(envelope)

    # -- value selection --------------------------------------------------------
    def _new_value_from_nomination(self, nom: SCPNomination) -> bytes:
        """Adopt the leader's highest-hashed value we don't already vote for;
        invalid values may still contribute via extract_valid_value."""
        d = self.slot.driver
        best, best_hash = b"", 0
        for value in list(nom.votes) + list(nom.accepted):
            candidate = (
                value
                if d.validate_value(self.slot.index, value)
                else d.extract_valid_value(self.slot.index, value)
            )
            if candidate and candidate not in self.votes:
                h = d.compute_value_hash(
                    self.slot.index, self.previous_value, self.round_number, candidate
                )
                if h >= best_hash:
                    best_hash, best = h, candidate
        return best

    # -- inbound ------------------------------------------------------------------
    def process_envelope(self, envelope: SCPEnvelope) -> EnvelopeState:
        st = envelope.statement
        nom = st.pledges.nominate
        if not self._is_newer_from(st.nodeID, nom) or not self._is_sane(st):
            return EnvelopeState.INVALID
        self._record_envelope(envelope)
        if not self.started:
            return EnvelopeState.VALID

        d = self.slot.driver
        modified = False
        new_candidates = False

        # promote votes to accepted
        for v in nom.votes:
            if v in self.accepted:
                continue
            if self.slot.federated_accept(
                lambda s, v=v: v in s.pledges.nominate.votes,
                lambda s, v=v: v in s.pledges.nominate.accepted,
                self.latest_nominations,
            ):
                if d.validate_value(self.slot.index, v):
                    self.accepted.add(v)
                    self.votes.add(v)
                    modified = True
                else:
                    # well-supported but locally invalid: vote for a valid
                    # variation if one can be extracted
                    alt = d.extract_valid_value(self.slot.index, v)
                    if alt and alt not in self.votes:
                        self.votes.add(alt)
                        modified = True

        # promote accepted to candidates
        for a in self.accepted:
            if a in self.candidates:
                continue
            if self.slot.federated_ratify(
                lambda s, a=a: a in s.pledges.nominate.accepted, self.latest_nominations
            ):
                self.candidates.add(a)
                new_candidates = True

        # still looking for a first candidate: adopt from round leaders
        if not self.candidates and st.nodeID in self.round_leaders:
            new_vote = self._new_value_from_nomination(nom)
            if new_vote:
                self.votes.add(new_vote)
                modified = True

        if modified:
            self._emit_nomination()

        if new_candidates:
            self.latest_composite = d.combine_candidates(self.slot.index, set(self.candidates))
            d.updated_candidate_value(self.slot.index, self.latest_composite)
            self.slot.bump_state(self.latest_composite, force=False)

        return EnvelopeState.VALID

    # -- local rounds ----------------------------------------------------------
    def nominate(self, value: bytes, previous_value: bytes, timed_out: bool) -> bool:
        from .slot import NOMINATION_TIMER

        self.started = True
        self.previous_value = previous_value
        self.round_number += 1
        # monitoring hook: round boundaries drive the host's span tracing
        # (round N's span closes when round N+1 starts, a ballot begins, or
        # the slot externalizes — Herder.nomination_round_started)
        self.slot.driver.nomination_round_started(
            self.slot.index, self.round_number, timed_out
        )
        self._update_round_leaders()

        updated = False
        nominating = b""
        if self.slot.local_node_id() in self.round_leaders:
            if value not in self.votes:
                self.votes.add(value)
                updated = True
            nominating = value
        else:
            for leader in self.round_leaders:
                env = self.latest_nominations.get(leader)
                if env is not None:
                    nominating = self._new_value_from_nomination(
                        env.statement.pledges.nominate
                    )
                    if nominating:
                        self.votes.add(nominating)
                        updated = True

        d = self.slot.driver
        d.nominating_value(self.slot.index, nominating)
        timeout = d.compute_timeout(self.round_number)
        d.setup_timer(
            self.slot.index,
            NOMINATION_TIMER,
            timeout,
            lambda: self.slot.nominate(value, previous_value, timed_out=True),
        )
        if updated:
            self._emit_nomination()
        return updated

    # -- restart-from-disk ---------------------------------------------------------
    def set_state_from_envelope(self, e: SCPEnvelope) -> None:
        if self.started:
            raise RuntimeError("cannot set state after nomination started")
        self._record_envelope(e)
        nom = e.statement.pledges.nominate
        self.accepted.update(nom.accepted)
        self.votes.update(nom.votes)
        self.last_envelope = e

    def get_current_state(self) -> List[SCPEnvelope]:
        return list(self.latest_nominations.values())

    def dump_info(self) -> dict:
        return {
            "round": self.round_number,
            "started": self.started,
            "X": [v.hex()[:12] for v in sorted(self.votes)],
            "Y": [v.hex()[:12] for v in sorted(self.accepted)],
            "Z": [v.hex()[:12] for v in sorted(self.candidates)],
        }
