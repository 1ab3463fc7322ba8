"""Durable file-system writes + the storage kill-point plane.

Every durable artifact this node writes (bucket files, history staging,
the publish-commit JSON) must reach disk through the helpers here:
write-tmp → fsync(file) → rename → fsync(dir), the same discipline the
reference gets from its own Fs.cpp + rename idiom.  A bare
``open(path, "wb")`` on a durable path elsewhere is an analysis
violation (``durable-write`` rule) — the contract that keeps future
writers crash-safe.

The same choke points double as the chaos plane's STORAGE fault surface:
each durable boundary is a named **kill-point** (registered at import
time so ``python -m stellar_tpu.scenarios --kill-sweep`` can enumerate
them), and ``kill_point()`` consults the installed hooks — a trace
recorder during sweep control runs, a ``StorageFaultInjector``
(scenarios/storagefaults.py) during kill runs.  With no hooks installed
the call is one global read + a falsy check, cheap enough for the close
path.

Stage suffix convention for file sites:

- ``:write``   — the payload bytes are fully written (and flushed to the
                 OS) but NOT yet fsynced; torn/truncated-file faults
                 corrupt the on-disk file here before killing.
- ``:staged``  — file fsynced, rename not yet performed (the classic
                 post-write-pre-rename kill).
- ``:renamed`` — renamed into place, directory entry not yet fsynced.

SQL/state boundaries register single names (``db.commit:pre`` etc.).
"""

from __future__ import annotations

import os
import uuid
from typing import Callable, Dict, List, Optional, Tuple

STAGE_WRITE = ":write"
STAGE_STAGED = ":staged"
STAGE_RENAMED = ":renamed"


class SimulatedProcessKill(BaseException):
    """Raised by an in-process storage-fault injector at a kill-point:
    models the process dying at exactly that durable-write boundary.
    Derives from BaseException so no ``except Exception`` recovery path
    can 'survive' its own death — the unwind mirrors a real kill (any
    open SQL transaction rolls back via the context managers, exactly
    what a restart would observe).  Simulation.crank_until catches it
    and reaps the node."""

    def __init__(self, point: str, ctx=None):
        super().__init__(point)
        self.point = point
        self.ctx = ctx


# -- kill-point registry -----------------------------------------------------

# name -> doc; populated at import time by the modules that own each
# durable boundary, so the sweep can enumerate points without running
_REGISTRY: Dict[str, str] = {}

# installed hooks: callables (name, path, ctx) -> None.  Hooks may raise
# SimulatedProcessKill or call os._exit; order is install order.
_hooks: List[Callable[[str, Optional[str], object], None]] = []


def register_kill_point(name: str, doc: str = "") -> str:
    _REGISTRY.setdefault(name, doc)
    return name


def register_durable_site(
    name: str,
    stages: Tuple[str, ...] = (STAGE_WRITE, STAGE_STAGED, STAGE_RENAMED),
    doc: str = "",
) -> str:
    """Register one file-writing site with its stage sub-points; returns
    the bare site name (the helpers derive the stage names from it)."""
    for st in stages:
        register_kill_point(name + st, doc)
    return name


def registered_kill_points() -> Dict[str, str]:
    return dict(_REGISTRY)


def add_kill_hook(hook: Callable) -> None:
    _hooks.append(hook)


def remove_kill_hook(hook: Callable) -> None:
    try:
        _hooks.remove(hook)
    except ValueError:
        pass


def clear_kill_hooks() -> None:
    del _hooks[:]


def kill_point(name: str, path: Optional[str] = None, ctx=None) -> None:
    """One named durable-write boundary.  No-op (one falsy check) unless
    a chaos hook is installed; hooks may corrupt ``path``, exit the
    process, or raise SimulatedProcessKill."""
    if not _hooks:
        return
    # snapshot: a hook that uninstalls itself must not skip its sibling
    for h in tuple(_hooks):
        h(name, path, ctx)


# -- durable-write helpers ---------------------------------------------------


def fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename into it is durable.  Best-effort:
    some filesystems/platforms refuse O_RDONLY on directories — the
    rename itself is still atomic, only the OS-crash window widens."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def stage_write(path: str, data: bytes, point: Optional[str] = None, ctx=None) -> None:
    """Write + fsync a STAGING file in place (no rename) — for artifacts
    a later adoption step renames to their content-addressed home
    (``durable_rename``).  Kill-points: ``<point>:write`` (payload on
    disk, unsynced), ``<point>:staged`` (fsynced)."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        if point is not None:
            kill_point(point + STAGE_WRITE, path=path, ctx=ctx)
        os.fsync(f.fileno())
    if point is not None:
        kill_point(point + STAGE_STAGED, path=path, ctx=ctx)


def durable_rename(
    tmp: str,
    final: str,
    point: Optional[str] = None,
    ctx=None,
    presynced: bool = False,
) -> None:
    """Atomically move a fully-written staging file into place:
    fsync(file) → rename → fsync(dir).  Safe against a kill at any
    point: either the old name or the complete new file survives.
    ``presynced=True`` skips the file fsync for callers whose staging
    step already synced it (``stage_write`` / a durable stream close) —
    fsync dominates the discipline's cost on the close path."""
    if not presynced:
        fsync_path(tmp)
    if point is not None:
        kill_point(point + STAGE_STAGED, path=tmp, ctx=ctx)
    os.replace(tmp, final)
    if point is not None:
        kill_point(point + STAGE_RENAMED, path=final, ctx=ctx)
    fsync_dir(os.path.dirname(os.path.abspath(final)))


def durable_write(
    path: str, data, point: Optional[str] = None, ctx=None
) -> None:
    """The full atomic-durable write for one-shot artifacts:
    write-tmp → fsync → rename over ``path`` → fsync(dir).  ``data``
    may be str (utf-8) or bytes."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(
        d, f".durable-{uuid.uuid4().hex[:12]}-{os.path.basename(path)}"
    )
    try:
        stage_write(tmp, data, point=point, ctx=ctx)
        os.replace(tmp, path)
    except SimulatedProcessKill:
        # an in-process kill leaves the orphan tmp for the boot reaper,
        # exactly like a real process death would
        raise
    except BaseException:
        # never leave the orphan tmp behind on a Python-level failure
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if point is not None:
        kill_point(point + STAGE_RENAMED, path=path, ctx=ctx)
    fsync_dir(d)
