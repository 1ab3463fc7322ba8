"""BucketManager — owns the bucket directory and the hash→Bucket map
(reference: src/bucket/BucketManagerImpl.{h,cpp}).

Content-addressed: a merged/fresh bucket file is renamed to
``bucket-<hash>.xdr`` inside the bucket dir and shared by hash thereafter.
Worker threads adopt buckets concurrently (merges run on the pool), so the
map is lock-guarded — the reference's one mutex-guarded subsystem outside
crypto (BucketManagerImpl.h mBucketMutex).

GC (``forget_unreferenced_buckets``) drops map entries and files whose hash
is no longer referenced by the live bucket list, any in-progress future
merge, or any queued-but-unpublished history checkpoint state.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ..util import fs, xlog
from .bucket import ZERO_HASH, Bucket
from .bucketlist import BucketList

log = xlog.logger("Bucket")

# adoption is the rename half of every bucket write's durability story
KP_ADOPT = fs.register_durable_site(
    "bucket.adopt", stages=(fs.STAGE_STAGED, fs.STAGE_RENAMED),
    doc="staged bucket renamed to its content-addressed canonical name",
)


class BucketManager:
    def __init__(self, app):
        self.app = app
        self.bucket_list = BucketList()
        self._buckets: Dict[bytes, Bucket] = {}
        self._lock = threading.Lock()
        self.last_checkdb: Optional[dict] = None
        self._checkdb_run = None
        # NB: must NOT live under TMP_DIR_PATH — that root is wiped on app
        # construction, and buckets must survive restart (merge resume).
        self.bucket_dir = os.path.abspath(app.config.BUCKET_DIR_PATH)
        os.makedirs(self.bucket_dir, exist_ok=True)
        # sweep merge temp files (and boot-quarantined corpses) orphaned
        # by a crash — the dir is persistent by design, so nothing else
        # cleans them.  Counted so the boot self-check can meter it.
        self.tmp_swept_at_boot = 0
        for name in os.listdir(self.bucket_dir):
            if name.startswith((".durable-", "tmp-bucket-")) or (
                ".quarantined" in name
            ):
                try:
                    os.unlink(os.path.join(self.bucket_dir, name))
                    self.tmp_swept_at_boot += 1
                except OSError:
                    pass

    # -- paths -------------------------------------------------------------
    def get_tmp_dir(self) -> str:
        return self.bucket_dir

    def bucket_filename(self, h: bytes) -> str:
        return os.path.join(self.bucket_dir, f"bucket-{h.hex()}.xdr")

    # -- adoption / lookup (BucketManagerImpl::adoptFileAsBucket) ----------
    def adopt_file_as_bucket(self, path: str, h: bytes, objects: int) -> Bucket:
        with self._lock:
            existing = self._buckets.get(h)
            if existing is not None:
                os.unlink(path)
                return existing
            canonical = self.bucket_filename(h)
            # every producer stages through the fs discipline (fresh /
            # _write_merged sync on close, the native merge fsyncs
            # explicitly), so the file is already durable — skip the
            # redundant per-adoption fsync
            fs.durable_rename(
                path, canonical, point=KP_ADOPT, ctx=self.app.database,
                presynced=True,
            )
            b = Bucket(canonical, h, objects)
            self._buckets[h] = b
            return b

    def get_bucket_by_hash(self, h: bytes) -> Bucket:
        if h == ZERO_HASH:
            return Bucket()
        with self._lock:
            b = self._buckets.get(h)
            if b is not None:
                return b
            path = self.bucket_filename(h)
            if os.path.exists(path):
                b = Bucket(path, h)
                self._buckets[h] = b
                return b
        raise KeyError(f"no bucket with hash {h.hex()}")

    def has_bucket(self, h: bytes) -> bool:
        if h == ZERO_HASH:
            return True
        with self._lock:
            return h in self._buckets or os.path.exists(self.bucket_filename(h))

    def check_for_missing_bucket_files(self, has) -> list:
        """Hashes referenced by a HistoryArchiveState with no file on disk,
        deduplicated — one hash can back several levels/merges (reference:
        BucketManagerImpl::checkForMissingBucketsFiles, used by the
        boot-time bucket repair at LedgerManagerImpl.cpp:233-247)."""
        missing = []
        seen = set()  # ordered result, O(1) dedup
        for h in has.all_bucket_hashes():
            if (
                h != ZERO_HASH
                and h not in seen
                and not os.path.exists(self.bucket_filename(h))
            ):
                seen.add(h)
                missing.append(h)
        return missing

    # -- on-disk integrity (boot self-check, stellar_tpu/main/selfcheck.py) -
    def verify_bucket_file(self, h: bytes) -> str:
        """One referenced bucket file's on-disk state: ``"ok"``,
        ``"missing"``, or ``"corrupt"`` (zero-length, truncated, or any
        content whose SHA256 is not the name — the hash IS the file's
        identity, so a full re-hash is the only honest check)."""
        if h == ZERO_HASH:
            return "ok"
        path = self.bucket_filename(h)
        if not os.path.exists(path):
            return "missing"
        if os.path.getsize(path) == 0:
            return "corrupt"
        # v2 re-hash through the state-plane pipeline (hashplane.py):
        # per-record digests fan over device lanes / pooled C tiles, so
        # the boot self-check's full-tree re-hash scales with cores —
        # and a frame-level parse failure is corruption by definition
        from . import hashplane

        try:
            got, _count = hashplane.hash_file(path, config=self.app.config)
        except (ValueError, OSError):
            return "corrupt"
        return "ok" if got == h else "corrupt"

    def verify_bucket_files(self, *states) -> dict:
        """Every hash the given HistoryArchiveState(s) reference,
        classified (deduplicated across states) — the integrity
        extension of ``check_for_missing_bucket_files``.  The boot
        self-check feeds the persisted HAS plus every queued-checkpoint
        state through here (main/selfcheck.py)."""
        out = {"ok": [], "missing": [], "corrupt": []}
        seen = set()
        for has in states:
            for h in has.all_bucket_hashes():
                if h == ZERO_HASH or h in seen:
                    continue
                seen.add(h)
                out[self.verify_bucket_file(h)].append(h)
        return out

    def quarantine_bucket_file(self, h: bytes) -> None:
        """Move a failed-verification file out of the content-addressed
        namespace so every downstream path (has_bucket, the boot repair's
        missing-file scan, catchup) treats it as MISSING rather than
        trusting corrupt bytes.  The corpse keeps its data for forensics
        until the next boot's tmp sweep reaps it."""
        path = self.bucket_filename(h)
        try:
            # analysis: off durable-write -- quarantine moves already-CORRUPT bytes out of the namespace; fsync discipline buys nothing (a crash mid-move just re-quarantines at the next boot — idempotent)
            os.replace(path, path + ".quarantined")
        except OSError:
            pass
        with self._lock:
            self._buckets.pop(h, None)

    # -- ledger-close interface (LedgerManager calls these) ----------------
    def add_batch(self, ledger_seq: int, live_entries, dead_entries) -> None:
        self.bucket_list.add_batch(self.app, ledger_seq, live_entries, dead_entries)

    # ledger-header snapshot hooks (reference BucketManagerImpl.cpp:300-332)
    SKIP_1 = 50
    SKIP_2 = 5000
    SKIP_3 = 50000
    SKIP_4 = 500000

    def snapshot_ledger(self, header) -> None:
        """Write bucketListHash + rotate the header skipList
        (reference: BucketManagerImpl::snapshotLedger, .cpp:300-306)."""
        header.bucketListHash = self.get_hash()
        self.calculate_skip_values(header)

    def calculate_skip_values(self, header) -> None:
        """skipList rotation at SKIP_1/2/3/4 boundaries (reference:
        BucketManagerImpl::calculateSkipValues, .cpp:308-331; behavior
        pinned by BucketTests.cpp:100-176)."""
        if header.ledgerSeq % self.SKIP_1 != 0:
            return
        v = header.ledgerSeq - self.SKIP_1
        if v > 0 and v % self.SKIP_2 == 0:
            v = header.ledgerSeq - self.SKIP_2 - self.SKIP_1
            if v > 0 and v % self.SKIP_3 == 0:
                v = header.ledgerSeq - self.SKIP_3 - self.SKIP_2 - self.SKIP_1
                if v > 0 and v % self.SKIP_4 == 0:
                    header.skipList[3] = header.skipList[2]
                header.skipList[2] = header.skipList[1]
            header.skipList[1] = header.skipList[0]
        header.skipList[0] = header.bucketListHash

    def get_hash(self) -> bytes:
        return self.bucket_list.get_hash()

    def archive_state_json(self, ledger_seq: int) -> str:
        from ..history.archive import HistoryArchiveState

        return HistoryArchiveState.from_bucket_list(
            ledger_seq, self.bucket_list
        ).to_json()

    # -- restart / catchup (BucketManagerImpl::assumeState) ----------------
    def assume_state(self, state_json: str) -> None:
        """Adopt a serialized bucket-list shape (boot after restart, or the
        end of catchup-minimal).  Buckets must exist in the bucket dir."""
        from ..bucket.futurebucket import FutureBucket
        from ..history.archive import HistoryArchiveState

        has = HistoryArchiveState.from_json(state_json)
        for i, lev_state in enumerate(has.current_buckets):
            lev = self.bucket_list.get_level(i)
            lev.curr = self.get_bucket_by_hash(lev_state.curr)
            lev.snap = self.get_bucket_by_hash(lev_state.snap)
            lev.next = FutureBucket.from_state(lev_state.next)
        self.bucket_list.restart_merges(self.app)

    def restart_merges(self) -> None:
        self.bucket_list.restart_merges(self.app)

    # -- audit (reference: BucketManagerImpl::checkDB / 'checkdb' command) -
    def check_db(self) -> dict:
        """Replay the whole bucket list oldest→newest into a live map and
        compare every entry (and the table counts) against the SQL store.
        Returns a report; raises RuntimeError on any mismatch."""
        from ..ledger.entryframe import (
            entry_cache_of,
            ledger_key_of,
            load_entry_by_key,
        )
        from ..xdr.entries import LedgerEntryType
        from ..xdr.ledger import BucketEntryType

        # the frame loaders consult the entry cache first; flush it so every
        # comparison below reads the actual SQL rows (the whole point)
        entry_cache_of(self.app.database).clear()
        state = {}
        for lev in reversed(self.bucket_list.levels):
            for b in (lev.snap, lev.curr):
                for e in b:
                    if e.type == BucketEntryType.LIVEENTRY:
                        state[ledger_key_of(e.value).to_xdr()] = e.value
                    else:
                        state.pop(e.value.to_xdr(), None)
        db = self.app.database
        counts = {LedgerEntryType.ACCOUNT: 0, LedgerEntryType.TRUSTLINE: 0,
                  LedgerEntryType.OFFER: 0}
        from ..xdr.ledger import LedgerKey

        compared = 0
        for key_xdr, entry in state.items():
            key = LedgerKey.from_xdr(key_xdr)
            counts[key.type] += 1
            frame = load_entry_by_key(key, db)
            if frame is None:
                raise RuntimeError(f"checkdb: entry missing from DB: {key}")
            if frame.entry.to_xdr() != entry.to_xdr():
                raise RuntimeError(f"checkdb: entry differs from DB: {key}")
            compared += 1
        entry_cache_of(db).clear()  # don't leave audit reads as the hot set
        table_counts = {
            LedgerEntryType.ACCOUNT: db.query_one(
                "SELECT COUNT(*) FROM accounts")[0],
            LedgerEntryType.TRUSTLINE: db.query_one(
                "SELECT COUNT(*) FROM trustlines")[0],
            LedgerEntryType.OFFER: db.query_one("SELECT COUNT(*) FROM offers")[0],
        }
        for ty, n in counts.items():
            if table_counts[ty] != n:
                raise RuntimeError(
                    f"checkdb: {ty.name} count mismatch: "
                    f"buckets={n} db={table_counts[ty]}"
                )
        return {
            "status": "ok",
            "objects_compared": compared,
            "accounts": counts[LedgerEntryType.ACCOUNT],
            "trustlines": counts[LedgerEntryType.TRUSTLINE],
            "offers": counts[LedgerEntryType.OFFER],
        }

    def start_check_db_async(self, batch: int = 2000) -> dict:
        """Cooperative audit for the admin API: one bucket (then one
        ``batch`` of SQL comparisons) per crank, so the reactor keeps
        serving SCP and peers during a long scan.  Aborts if a ledger
        closes mid-audit (the snapshot would no longer be consistent).
        Result lands in ``self.last_checkdb``."""
        if getattr(self, "_checkdb_run", None) is not None:
            return {"status": "running", **self._checkdb_run.progress()}
        run = _CheckDBRun(self, batch)
        self._checkdb_run = run
        self.app.clock.post(run.step)
        return {"status": "started"}

    # -- GC (BucketManagerImpl::forgetUnreferencedBuckets) -----------------
    def referenced_hashes(self) -> set:
        refs = set()
        for lev in self.bucket_list.levels:
            refs.add(lev.curr.get_hash())
            refs.add(lev.snap.get_hash())
            refs.update(lev.next.referenced_hashes())
        # queued-but-unpublished checkpoints still need their buckets
        from ..history import publish as publish_queue
        from ..history.archive import HistoryArchiveState

        for _seq, state_json in publish_queue.queued_checkpoints(self.app.database):
            refs.update(HistoryArchiveState.from_json(state_json).all_bucket_hashes())
        refs.discard(ZERO_HASH)
        return refs

    def forget_unreferenced_buckets(self) -> None:
        # A worker adopts its merge output before the future records the
        # output hash; GC while a merge is in flight could catch that window
        # and delete the fresh output.  Merges only start from the main
        # thread, so checking completion first closes the race.
        for lev in self.bucket_list.levels:
            if lev.next.is_live() and not lev.next._done.is_set():
                return  # defer GC to the next close
        try:
            refs = self.referenced_hashes()
        except Exception as e:
            log.error("skipping bucket GC, could not compute referenced set: %s", e)
            return
        with self._lock:
            for h in list(self._buckets):
                if h not in refs:
                    b = self._buckets.pop(h)
                    try:
                        if b.path:
                            os.unlink(b.path)
                    except OSError:
                        pass


class _CheckDBRun:
    """Incremental checkdb: replays one bucket per crank into the live map,
    then compares SQL rows in batches; consistency guarded by aborting if
    the LCL moves (the reference gets isolation from worker-thread DB
    snapshots instead — sqlite in-process has no second session)."""

    def __init__(self, bm: BucketManager, batch: int):
        from ..ledger.entryframe import entry_cache_of

        self.bm = bm
        self.app = bm.app
        self.batch = batch
        self.start_lcl = self.app.ledger_manager.last_closed.header.ledgerSeq
        self.buckets = [
            b
            for lev in reversed(bm.bucket_list.levels)
            for b in (lev.snap, lev.curr)
        ]
        self.state: Dict[bytes, object] = {}
        self._replay_iter = None  # held iterator into the current bucket
        self.items = None  # iterator over final state, set after replay
        self.compared = 0
        self.counts = None
        entry_cache_of(self.app.database).clear()

    def progress(self) -> dict:
        return {
            "buckets_left": len(self.buckets),
            "objects_compared": self.compared,
        }

    def _finish(self, report: dict) -> None:
        from ..ledger.entryframe import entry_cache_of

        entry_cache_of(self.app.database).clear()
        self.bm.last_checkdb = report
        self.bm._checkdb_run = None
        if report.get("status") != "ok":
            log.error("checkdb failed: %s", report)
        else:
            log.info("checkdb ok: %s objects", report.get("objects_compared"))

    def step(self) -> None:
        from ..ledger.entryframe import ledger_key_of, load_entry_by_key
        from ..xdr.entries import LedgerEntryType
        from ..xdr.ledger import BucketEntryType, LedgerKey

        if (
            self.app.ledger_manager.last_closed.header.ledgerSeq
            != self.start_lcl
        ):
            self._finish(
                {"status": "aborted", "error": "ledger closed during audit"}
            )
            return
        try:
            if self.buckets or self._replay_iter is not None:
                # bounded replay: the deepest bucket holds most of the
                # entries, so one-whole-bucket-per-crank would block the
                # reactor nearly as long as a synchronous scan — hold an
                # iterator into the current bucket and replay at most
                # 10*batch entries per crank
                budget = self.batch * 10
                while budget > 0:
                    if self._replay_iter is None:
                        if not self.buckets:
                            break
                        self._replay_iter = iter(self.buckets.pop(0))
                    e = next(self._replay_iter, None)
                    if e is None:
                        self._replay_iter = None
                        continue
                    if e.type == BucketEntryType.LIVEENTRY:
                        self.state[ledger_key_of(e.value).to_xdr()] = e.value
                    else:
                        self.state.pop(e.value.to_xdr(), None)
                    budget -= 1
                if self.buckets or self._replay_iter is not None:
                    self.app.clock.post(self.step)
                    return
            if self.items is None:
                self.items = iter(list(self.state.items()))
                self.counts = {
                    LedgerEntryType.ACCOUNT: 0,
                    LedgerEntryType.TRUSTLINE: 0,
                    LedgerEntryType.OFFER: 0,
                }
            db = self.app.database
            for _ in range(self.batch):
                nxt = next(self.items, None)
                if nxt is None:
                    table_counts = {
                        LedgerEntryType.ACCOUNT: db.query_one(
                            "SELECT COUNT(*) FROM accounts")[0],
                        LedgerEntryType.TRUSTLINE: db.query_one(
                            "SELECT COUNT(*) FROM trustlines")[0],
                        LedgerEntryType.OFFER: db.query_one(
                            "SELECT COUNT(*) FROM offers")[0],
                    }
                    for ty, n in self.counts.items():
                        if table_counts[ty] != n:
                            raise RuntimeError(
                                f"{ty.name} count mismatch: buckets={n} "
                                f"db={table_counts[ty]}"
                            )
                    self._finish({
                        "status": "ok",
                        "objects_compared": self.compared,
                        "accounts": self.counts[LedgerEntryType.ACCOUNT],
                        "trustlines": self.counts[LedgerEntryType.TRUSTLINE],
                        "offers": self.counts[LedgerEntryType.OFFER],
                    })
                    return
                key_xdr, entry = nxt
                key = LedgerKey.from_xdr(key_xdr)
                self.counts[key.type] += 1
                frame = load_entry_by_key(key, db)
                if frame is None:
                    raise RuntimeError(f"entry missing from DB: {key}")
                if frame.entry.to_xdr() != entry.to_xdr():
                    raise RuntimeError(f"entry differs from DB: {key}")
                self.compared += 1
            self.app.clock.post(self.step)
        except Exception as e:
            self._finish({"status": "error", "error": str(e)})
