"""Slot — consensus state for one slot index (reference: src/scp/Slot.{h,cpp}).

Routes envelopes to the nomination or ballot sub-protocol and provides the
federated-voting primitives both share:

  federated_accept:  a v-blocking set *accepted* it, OR a transitive quorum
                     voted-or-accepted it (safe to accept ourselves).
  federated_ratify:  a transitive quorum voted for it (confirmed).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..xdr.scp import SCPEnvelope, SCPQuorumSet, SCPStatement, SCPStatementType
from ..xdr.xtypes import NodeID
from . import quorum
from .ballot import BallotProtocol, working_ballot
from .driver import EnvelopeState
from .nomination import NominationProtocol

NOMINATION_TIMER = 0
BALLOT_PROTOCOL_TIMER = 1

ST = SCPStatementType


class Slot:
    def __init__(self, slot_index: int, scp):
        self.index = slot_index
        self.scp = scp
        self.ballot = BallotProtocol(self)
        self.nomination = NominationProtocol(self)
        self.statements_history: List[SCPStatement] = []

    # -- context accessors ---------------------------------------------------
    @property
    def driver(self):
        return self.scp.driver

    def local_node_id(self) -> NodeID:
        return self.scp.node_id

    def local_qset(self) -> SCPQuorumSet:
        return self.scp.local_qset

    def local_qset_hash(self) -> bytes:
        return self.scp.local_qset_hash

    # -- envelope plumbing ----------------------------------------------------
    def record_statement(self, st: SCPStatement) -> None:
        self.statements_history.append(st)

    def create_envelope(self, statement: SCPStatement) -> SCPEnvelope:
        envelope = SCPEnvelope(statement=statement, signature=b"")
        self.driver.sign_envelope(envelope)
        return envelope

    def process_envelope(self, envelope: SCPEnvelope) -> EnvelopeState:
        assert envelope.statement.slotIndex == self.index
        if envelope.statement.pledges.type == ST.SCP_ST_NOMINATE:
            return self.nomination.process_envelope(envelope)
        return self.ballot.process_envelope(envelope)

    # -- actions ----------------------------------------------------------------
    def nominate(self, value: bytes, previous_value: bytes, timed_out: bool = False) -> bool:
        return self.nomination.nominate(value, previous_value, timed_out)

    def bump_state(self, value: bytes, force: bool) -> bool:
        return self.ballot.bump_state(value, force)

    def abandon_ballot(self) -> bool:
        return self.ballot.abandon_ballot()

    def latest_composite_candidate(self) -> bytes:
        return self.nomination.latest_composite

    # -- statement interpretation ------------------------------------------------
    @staticmethod
    def statement_values(st: SCPStatement) -> List[bytes]:
        if st.pledges.type == ST.SCP_ST_NOMINATE:
            nom = st.pledges.nominate
            return list(nom.votes) + list(nom.accepted)
        return [working_ballot(st).value]

    @staticmethod
    def companion_qset_hash(st: SCPStatement) -> Optional[bytes]:
        """The quorum-set hash a statement depends on; None for EXTERNALIZE,
        which stands alone (Slot.cpp getCompanionQuorumSetHashFromStatement —
        there EXTERNALIZE still names its last qset, but nothing resolves
        through it: the statement is treated as a self-quorum)."""
        t = st.pledges.type
        if t == ST.SCP_ST_PREPARE:
            return st.pledges.prepare.quorumSetHash
        if t == ST.SCP_ST_CONFIRM:
            return st.pledges.confirm.quorumSetHash
        if t == ST.SCP_ST_NOMINATE:
            return st.pledges.nominate.quorumSetHash
        return None

    def quorum_set_from_statement(self, st: SCPStatement) -> Optional[SCPQuorumSet]:
        """EXTERNALIZE carries no qset promise anymore — the node is
        committed alone; everything else names a qset by hash, resolved
        through the driver's cache."""
        h = self.companion_qset_hash(st)
        if h is None:
            return quorum.singleton_qset(st.nodeID)
        return self.driver.get_qset(h)

    # -- federated voting ----------------------------------------------------------
    def federated_accept(
        self,
        voted: Callable[[SCPStatement], bool],
        accepted: Callable[[SCPStatement], bool],
        envs: Dict[NodeID, SCPEnvelope],
    ) -> bool:
        if quorum.is_v_blocking_with(self.local_qset(), envs, accepted):
            return True
        return quorum.is_quorum_with(
            self.local_qset(),
            envs,
            self.quorum_set_from_statement,
            lambda st: accepted(st) or voted(st),
        )

    def federated_ratify(
        self, voted: Callable[[SCPStatement], bool], envs: Dict[NodeID, SCPEnvelope]
    ) -> bool:
        return quorum.is_quorum_with(
            self.local_qset(), envs, self.quorum_set_from_statement, voted
        )

    # -- state persistence ------------------------------------------------------------
    def set_state_from_envelope(self, e: SCPEnvelope) -> None:
        if e.statement.nodeID == self.local_node_id() and e.statement.slotIndex == self.index:
            if e.statement.pledges.type == ST.SCP_ST_NOMINATE:
                self.nomination.set_state_from_envelope(e)
            else:
                self.ballot.set_state_from_envelope(e)

    def get_current_state(self) -> List[SCPEnvelope]:
        return self.nomination.get_current_state() + self.ballot.get_current_state()

    def get_latest_messages_send(self) -> List[SCPEnvelope]:
        res = []
        if self.nomination.last_envelope is not None:
            res.append(self.nomination.last_envelope)
        if self.ballot.last_envelope is not None:
            res.append(self.ballot.last_envelope)
        return res

    def statement_count(self) -> int:
        return len(self.statements_history)

    def dump_info(self) -> dict:
        return {
            "index": self.index,
            "nomination": self.nomination.dump_info(),
            "ballot": self.ballot.dump_info(),
        }
