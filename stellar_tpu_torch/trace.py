"""The tracer surface the verify plane calls: ``span``, ``begin``, ``end``.

The port carries only the disabled tracer (``NULL_TRACER``).  A caller may
pass any object with the same three methods (for example the node's own
span tracer) as ``tracer=`` and the verify plane records into it.
"""

from __future__ import annotations


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_SCOPE = _NoopScope()


class NullTracer:
    """A tracer that records nothing; ``end(None)`` is a no-op."""

    enabled = False

    def span(self, name: str, **attrs):
        return _NOOP_SCOPE

    def begin(self, name: str, **attrs):
        return None

    def end(self, span, **attrs) -> None:
        return None


NULL_TRACER = NullTracer()
