"""TmpDir / TmpDirManager / fs helpers (reference: src/util/TmpDir.*, Fs.*)."""

from __future__ import annotations

import os
import shutil
import uuid


def deltree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def mkpath(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def exists(path: str) -> bool:
    return os.path.exists(path)


class TmpDir:
    def __init__(self, path: str):
        self._path = path
        mkpath(path)

    def get_name(self) -> str:
        return self._path

    def __fspath__(self):
        return self._path


class TmpDirManager:
    """Owns a root dir of per-purpose temp subdirs, cleaned on forget/exit.

    A killed process leaves its in-flight ``publish-*``/``catchup-*``
    dirs behind; construction reaps every orphan (counted in
    ``reaped_at_boot`` so the boot self-check can meter it as
    ``selfcheck.tmp-reaped``).  The reap is guarded against IN-FLIGHT
    dirs: anything handed out by *this* manager instance is live and
    never reaped, so a runtime re-sweep can't destroy an active publish
    staging dir."""

    def __init__(self, root: str):
        self._root = root
        self._live: set = set()
        self.reaped_at_boot = self.reap_orphans()
        mkpath(root)

    def tmp_dir(self, prefix: str) -> TmpDir:
        d = TmpDir(os.path.join(self._root, f"{prefix}-{uuid.uuid4().hex[:12]}"))
        self._live.add(d.get_name())
        return d

    def forget(self, d: TmpDir) -> None:
        self._live.discard(d.get_name())
        deltree(d.get_name())

    def reap_orphans(self) -> int:
        """Remove (and count) every entry under the root not owned by a
        live TmpDir of this manager — the crashed-process leftovers."""
        if not os.path.isdir(self._root):
            return 0
        reaped = 0
        for name in os.listdir(self._root):
            path = os.path.join(self._root, name)
            if path in self._live:
                continue
            if os.path.isdir(path):
                deltree(path)
            else:
                try:
                    os.unlink(path)
                except OSError:
                    continue
            reaped += 1
        return reaped

    def get_root(self) -> str:
        return self._root
