"""stellar_tpu.crypto.aggregate — the aggregate-signature consensus plane.

A second signature scheme behind the SigBackend seam (ROADMAP #3):
ed25519 half-aggregation for SCP ballot envelopes, selected per quorum
set via ``Config.SCP_SIG_SCHEME``.  ``halfagg`` is the certificate core
(transcript-bound coefficients, one-MSM verification, native Pippenger
engine with a ref25519 oracle fallback); ``scheme`` is the dispatch seam
the herder/overlay route through (slot buckets, strict gate, per-envelope
fallback, valid-only cache latch).

The registry below is what ``Config.validate`` checks — an unknown scheme
name fails the boot, not the first flush.
"""

from __future__ import annotations

from .halfagg import (
    PointCache,
    aggregate,
    native_available,
    verify_aggregated,
    verify_batch_aggregated,
)
from .scheme import Ed25519Scheme, HalfAggScheme, ScpSigScheme, make_scheme

# every scheme name Config.SCP_SIG_SCHEME accepts
SIG_SCHEMES = ("ed25519", "ed25519-halfagg")
DEFAULT_SCHEME = "ed25519"


def validate_scheme(name) -> None:
    if name not in SIG_SCHEMES:
        raise ValueError(
            f"SCP_SIG_SCHEME must be one of {SIG_SCHEMES}, got {name!r}"
        )


__all__ = [
    "SIG_SCHEMES",
    "DEFAULT_SCHEME",
    "validate_scheme",
    "make_scheme",
    "ScpSigScheme",
    "Ed25519Scheme",
    "HalfAggScheme",
    "PointCache",
    "aggregate",
    "verify_aggregated",
    "verify_batch_aggregated",
    "native_available",
]
