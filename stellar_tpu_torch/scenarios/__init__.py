"""Adversarial-network chaos plane (ROADMAP #5).

Declarative chaos harness over the in-process Simulation: topology × load
× scheduled fault program × consensus-liveness scoreboard.  See
``scenario.py`` for the runner, ``faults.py`` for the fault vocabulary,
``matrix.py`` for the named small/big shapes per fault class, and
``python -m stellar_tpu.scenarios`` for the CI entry point
(relay_watch ``scenario_liveness_r12``).
"""

from .faults import (  # noqa: F401
    ByzantineFlood,
    CrashRestart,
    Fault,
    IngestFlood,
    OverloadStorm,
    Partition,
    PartitionUntilCheckpoint,
    SlowLossyLinks,
    SlowReader,
)
from .matrix import (  # noqa: F401
    FAULT_CLASSES,
    big_specs,
    run_matrix,
    small_specs,
)
from .scenario import Scenario, ScenarioResult, ScenarioSpec  # noqa: F401
from .scoreboard import LivenessScoreboard, snapshot  # noqa: F401

__all__ = [
    "ByzantineFlood",
    "CrashRestart",
    "Fault",
    "IngestFlood",
    "OverloadStorm",
    "SlowReader",
    "Partition",
    "PartitionUntilCheckpoint",
    "SlowLossyLinks",
    "FAULT_CLASSES",
    "big_specs",
    "run_matrix",
    "small_specs",
    "Scenario",
    "ScenarioResult",
    "ScenarioSpec",
    "LivenessScoreboard",
    "snapshot",
]
