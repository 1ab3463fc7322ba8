"""SCPDriver — the callback surface between the SCP library and its host
(reference: src/scp/SCPDriver.{h,cpp}).

The library never touches the network, clocks, or application validity rules
directly; everything flows through this interface.  The Herder implements it
for the real node; tests implement it with scripted no-op crypto
(SURVEY.md §4 layer 2).
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from typing import Callable, Iterable, Optional, Set

from ..crypto import SHA256, sha256
from ..xdr.base import int32, uint32, uint64, xdr_to_opaque
from ..xdr.scp import SCPEnvelope, SCPQuorumSet, VALUE
from ..xdr.xtypes import NODE_ID, NodeID


class EnvelopeState(enum.Enum):
    INVALID = 0
    VALID = 1


# domain separators for the nomination hashes (SCPDriver.cpp:32-34)
_HASH_N = 1  # neighborhood membership
_HASH_P = 2  # leader priority
_HASH_K = 3  # value ordering

MAX_TIMEOUT_SECONDS = 30 * 60


def _pack(codec, v) -> bytes:
    out = bytearray()
    codec.pack_into(v, out)
    return bytes(out)


class SCPDriver(ABC):
    # -- crypto ------------------------------------------------------------
    @abstractmethod
    def sign_envelope(self, envelope: SCPEnvelope) -> None: ...

    @abstractmethod
    def verify_envelope(self, envelope: SCPEnvelope) -> bool: ...

    # -- state the host keeps for the library ------------------------------
    @abstractmethod
    def get_qset(self, qset_hash: bytes) -> Optional[SCPQuorumSet]: ...

    @abstractmethod
    def emit_envelope(self, envelope: SCPEnvelope) -> None: ...

    # -- value semantics ----------------------------------------------------
    def validate_value(self, slot_index: int, value: bytes) -> bool:
        return True

    def extract_valid_value(self, slot_index: int, value: bytes) -> bytes:
        return b""

    @abstractmethod
    def combine_candidates(self, slot_index: int, candidates: Set[bytes]) -> bytes: ...

    # -- timers --------------------------------------------------------------
    @abstractmethod
    def setup_timer(
        self, slot_index: int, timer_id: int, timeout: float, cb: Optional[Callable[[], None]]
    ) -> None:
        """Arm (or, with cb=None, cancel) the per-slot timer; timeout in seconds."""

    def compute_timeout(self, round_number: int) -> float:
        """Linear backoff: round N waits N seconds, capped at 30 min
        (SCPDriver.cpp:78-96) — long enough for a quorum to exchange the
        4-message ballot dance."""
        return float(min(round_number, MAX_TIMEOUT_SECONDS))

    # -- nomination randomization -------------------------------------------
    def _hash_helper(self, slot_index: int, prev: bytes, extra: Iterable[bytes]) -> int:
        h = SHA256()
        h.add(_pack(uint64, slot_index))
        h.add(_pack(VALUE, prev))
        for chunk in extra:
            h.add(chunk)
        return int.from_bytes(h.finish()[:8], "big")

    def compute_hash_node(
        self, slot_index: int, prev: bytes, is_priority: bool, round_number: int, node_id: NodeID
    ) -> int:
        return self._hash_helper(
            slot_index,
            prev,
            (
                _pack(uint32, _HASH_P if is_priority else _HASH_N),
                _pack(int32, round_number),
                _pack(NODE_ID, node_id),
            ),
        )

    def compute_value_hash(
        self, slot_index: int, prev: bytes, round_number: int, value: bytes
    ) -> int:
        return self._hash_helper(
            slot_index,
            prev,
            (_pack(uint32, _HASH_K), _pack(int32, round_number), _pack(VALUE, value)),
        )

    # -- debugging -----------------------------------------------------------
    def get_value_string(self, value: bytes) -> str:
        return sha256(_pack(VALUE, value)).hex()[:12]

    def to_short_string(self, pk: NodeID) -> str:
        return pk.value.hex()[:12]

    # -- monitoring hooks (all optional) --------------------------------------
    def value_externalized(self, slot_index: int, value: bytes) -> None: ...

    def nominating_value(self, slot_index: int, value: bytes) -> None: ...

    def nomination_round_started(
        self, slot_index: int, round_number: int, timed_out: bool
    ) -> None:
        """A nomination round began (round_number is 1-based; timed_out is
        True when the previous round's timer re-entered nominate).  Hosts
        use this for per-round latency spans (trace/)."""

    def updated_candidate_value(self, slot_index: int, value: bytes) -> None: ...

    def started_ballot_protocol(self, slot_index: int, ballot) -> None: ...

    def accepted_ballot_prepared(self, slot_index: int, ballot) -> None: ...

    def confirmed_ballot_prepared(self, slot_index: int, ballot) -> None: ...

    def accepted_commit(self, slot_index: int, ballot) -> None: ...

    def ballot_did_hear_from_quorum(self, slot_index: int, ballot) -> None: ...
