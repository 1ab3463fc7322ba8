"""Partitioned loggers, named like the node's (``<package>.<partition>``)."""

from __future__ import annotations

import logging


def logger(partition: str) -> logging.Logger:
    return logging.getLogger(f"stellar_tpu_torch.{partition}")
