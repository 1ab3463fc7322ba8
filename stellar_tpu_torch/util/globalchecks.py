"""Thread-discipline asserts (reference: src/util/GlobalChecks.{h,cpp}).

The reference pins ``mainThread`` at static-init time and calls
``assertThreadIsMain()`` from VirtualClock (Timer.cpp), TCPPeer, and
Database.  Python's equivalent of "the main thread" is ambiguous under
pytest and embedding, so the discipline is per-reactor instead:
``VirtualClock`` records its constructing thread and the reactor entry
points (``post``, ``crank``) assert against it via ``assert_thread_is`` —
same invariant, bound to the object that owns it.  Violations raise in
debug runs and are compiled out under ``python -O`` like the reference's
NDEBUG build.
"""

from __future__ import annotations

import threading


def assert_thread_is(owner_tid: int) -> None:
    """Reactor objects record their constructing thread id and assert
    subsequent same-thread use (workers must use post_from_thread)."""
    assert threading.get_ident() == owner_tid, (
        "thread-affine object used from foreign thread "
        f"{threading.current_thread().name!r} (use post_from_thread)"
    )
