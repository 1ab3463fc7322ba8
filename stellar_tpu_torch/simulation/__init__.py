"""Multi-node in-process simulation (reference: src/simulation/)."""

from .loadgen import LoadGenerator, TestAccount
from .simulation import OVER_LOOPBACK, OVER_TCP, Simulation
from . import topologies

__all__ = [
    "LoadGenerator", "TestAccount", "OVER_LOOPBACK", "OVER_TCP",
    "Simulation", "topologies",
]
