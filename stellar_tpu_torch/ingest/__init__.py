"""Verify-at-ingest admission plane: the batched tx front door
(micro-batched signature verify under CALLER_INGEST, per-account rate
limits, fee-based surge admission).  See plane.py."""

from .plane import INGEST_STATUS_TRY_AGAIN, IngestPlane  # noqa: F401
