"""Subprocess management (reference: src/process/)."""

from .manager import ProcessExitEvent, ProcessManager

__all__ = ["ProcessExitEvent", "ProcessManager"]
