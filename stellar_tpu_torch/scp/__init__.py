"""SCP — federated Byzantine agreement consensus library
(reference: src/scp/, ~6.0 kLoC; see scp/readme.md there for the model).

Self-contained: depends only on the xdr and crypto layers, talks to its host
exclusively through :class:`SCPDriver` (the Herder implements it in the real
node; tests use scripted drivers)."""

from .driver import EnvelopeState, SCPDriver
from .scp import SCP
from .slot import BALLOT_PROTOCOL_TIMER, NOMINATION_TIMER, Slot
from . import quorum

__all__ = [
    "SCP",
    "SCPDriver",
    "EnvelopeState",
    "Slot",
    "quorum",
    "NOMINATION_TIMER",
    "BALLOT_PROTOCOL_TIMER",
]
