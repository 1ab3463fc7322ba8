"""FutureBucket — an in-progress (or potential) bucket merge
(reference: src/bucket/FutureBucket.{h,cpp}).

A FutureBucket is in one of three states:

- CLEAR: nothing here.
- LIVE: a merge is running on the worker pool (inputs held live); ``resolve``
  blocks until the output bucket exists.
- HASHES: only the input (or output) hashes are known — the deserialized
  form.  ``make_live`` re-launches the merge from hashes after a restart
  (BucketList::restartMerges), which is what makes merges resumable across
  process death: the merge is deterministic, so re-running it from the same
  inputs yields the same output hash.

Serialization round-trips through the HistoryArchiveState JSON
(history/archive.py), matching the reference's cereal form.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..util import xlog
from .bucket import Bucket

log = xlog.logger("Bucket")

FB_CLEAR = 0
FB_HASH_OUTPUT = 1
FB_HASH_INPUTS = 2
FB_LIVE_OUTPUT = 3
FB_LIVE_INPUTS = 4


class FutureBucket:
    def __init__(
        self,
        app=None,
        curr: Optional[Bucket] = None,
        snap: Optional[Bucket] = None,
        shadows: Optional[List[Bucket]] = None,
        keep_dead_entries: bool = True,
    ):
        self.state = FB_CLEAR
        self.keep_dead_entries = keep_dead_entries
        self.input_curr: Optional[Bucket] = None
        self.input_snap: Optional[Bucket] = None
        self.input_shadows: List[Bucket] = []
        self.input_curr_hash: Optional[bytes] = None
        self.input_snap_hash: Optional[bytes] = None
        self.input_shadow_hashes: List[bytes] = []
        self.output: Optional[Bucket] = None
        self.output_hash: Optional[bytes] = None
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        if curr is not None:
            assert app is not None and snap is not None
            self.input_curr = curr
            self.input_snap = snap
            self.input_shadows = list(shadows or [])
            self.input_curr_hash = curr.get_hash()
            self.input_snap_hash = snap.get_hash()
            self.input_shadow_hashes = [s.get_hash() for s in self.input_shadows]
            self.state = FB_LIVE_INPUTS
            self._start_merge(app)

    # -- state predicates (FutureBucket.h:40-70) ---------------------------
    def is_clear(self) -> bool:
        return self.state == FB_CLEAR

    def is_live(self) -> bool:
        return self.state in (FB_LIVE_INPUTS, FB_LIVE_OUTPUT)

    def is_merging(self) -> bool:
        return self.state == FB_LIVE_INPUTS and not self._done.is_set()

    def has_hashes(self) -> bool:
        return self.state in (FB_HASH_INPUTS, FB_HASH_OUTPUT)

    def has_output_hash(self) -> bool:
        return self.state in (FB_HASH_OUTPUT, FB_LIVE_OUTPUT) or (
            self.state == FB_LIVE_INPUTS
            and self._done.is_set()
            and self._error is None  # failed merge serializes as inputs,
            # so a restart re-launches it
        )

    def clear(self) -> None:
        self.__init__()

    # -- merge lifecycle ---------------------------------------------------
    def _start_merge(self, app) -> None:
        curr, snap = self.input_curr, self.input_snap
        shadows = self.input_shadows
        keep_dead = self.keep_dead_entries
        bm = app.bucket_manager

        def work():
            return Bucket.merge(bm, curr, snap, shadows, keep_dead)

        def done(result):
            if isinstance(result, BaseException):
                self._error = result
                log.error("bucket merge failed: %s", result)
            else:
                self.output = result
                self.output_hash = result.get_hash()
            self._done.set()

        # completion is recorded from the merging thread itself so
        # resolve() can block without needing the main loop to crank
        def run():
            try:
                done(work())
            except BaseException as e:  # pragma: no cover
                done(e)

        # dedicated merge workers (bucket/mergeworker.py):
        # spills merge in the background and the close boundary that
        # commits them finds them done.  Knob off = merge synchronously
        # right here (bit-exact differential baseline — the output hash
        # cannot depend on WHERE the deterministic merge ran)
        cfg = getattr(app, "config", None)
        if cfg is None or getattr(cfg, "BACKGROUND_BUCKET_MERGE", True):
            from . import mergeworker

            mergeworker.submit(run)
        else:
            run()

    def resolve(self) -> Bucket:
        """Block until merged; flip to LIVE_OUTPUT (FutureBucket::resolve)."""
        assert self.is_live()
        self._done.wait()
        if self._error is not None:
            raise self._error
        self.state = FB_LIVE_OUTPUT
        return self.output

    def merge_complete(self) -> bool:
        assert self.is_live()
        return self._done.is_set()

    def make_live(self, app) -> None:
        """Reanimate from hashes: either adopt the known output bucket, or
        re-launch the merge from input buckets (must exist on disk)."""
        assert self.has_hashes()
        bm = app.bucket_manager
        if self.state == FB_HASH_OUTPUT:
            self.output = bm.get_bucket_by_hash(self.output_hash)
            self._done.set()
            self.state = FB_LIVE_OUTPUT
        else:
            self.input_curr = bm.get_bucket_by_hash(self.input_curr_hash)
            self.input_snap = bm.get_bucket_by_hash(self.input_snap_hash)
            self.input_shadows = [
                bm.get_bucket_by_hash(h) for h in self.input_shadow_hashes
            ]
            self._done = threading.Event()
            self._error = None
            self.state = FB_LIVE_INPUTS
            self._start_merge(app)

    # -- (de)serialization (FutureBucket.h:98-118 / cereal form) -----------
    def to_state(self) -> dict:
        if self.is_live() or self.state == FB_HASH_OUTPUT:
            if self.has_output_hash():
                out = self.output_hash or (self.output and self.output.get_hash())
                return {"state": FB_HASH_OUTPUT, "output": out.hex()}
            return {
                "state": FB_HASH_INPUTS,
                "curr": self.input_curr_hash.hex(),
                "snap": self.input_snap_hash.hex(),
                "shadow": [h.hex() for h in self.input_shadow_hashes],
                "keepDead": self.keep_dead_entries,
            }
        if self.state == FB_HASH_INPUTS:
            return {
                "state": FB_HASH_INPUTS,
                "curr": self.input_curr_hash.hex(),
                "snap": self.input_snap_hash.hex(),
                "shadow": [h.hex() for h in self.input_shadow_hashes],
                "keepDead": self.keep_dead_entries,
            }
        return {"state": FB_CLEAR}

    @classmethod
    def from_state(cls, st: dict) -> "FutureBucket":
        fb = cls()
        s = st.get("state", FB_CLEAR)
        if s == FB_HASH_OUTPUT:
            fb.state = FB_HASH_OUTPUT
            fb.output_hash = bytes.fromhex(st["output"])
        elif s == FB_HASH_INPUTS:
            fb.state = FB_HASH_INPUTS
            fb.input_curr_hash = bytes.fromhex(st["curr"])
            fb.input_snap_hash = bytes.fromhex(st["snap"])
            fb.input_shadow_hashes = [bytes.fromhex(h) for h in st.get("shadow", [])]
            fb.keep_dead_entries = bool(st.get("keepDead", True))
        return fb

    def referenced_hashes(self) -> List[bytes]:
        """Every bucket hash this future pins (for GC + publish sets)."""
        out: List[bytes] = []
        if self.output_hash:
            out.append(self.output_hash)
        if self.output is not None:
            out.append(self.output.get_hash())
        for h in (self.input_curr_hash, self.input_snap_hash):
            if h:
                out.append(h)
        out.extend(self.input_shadow_hashes)
        return out
