"""Publish state machine — snapshot → gzip → observe → send → commit
(reference: src/history/PublishStateMachine.{h,cpp}).

One PublishRun handles one queued checkpoint against every writable archive:

1. SNAPSHOT: write the checkpoint's ledger/transactions/results XDR files
   from SQL into a staging tmp dir; stage the bucket files the archive
   state references.
2. COMPRESS: gzip every staged file via subprocesses.
3. OBSERVE (per archive): fetch the archive's current ``.well-known`` state
   to learn which buckets it already has.
4. SEND (per archive): mkdir + put the missing files.
5. COMMIT (per archive): put the per-checkpoint state file and the new
   ``.well-known`` root state.

Everything is subprocess-driven through ProcessManager, completions posted
back to the main crank; the queue row (crash-safe, written inside the
ledger-close transaction) is removed only after every archive commits.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, List, Optional

from ..util import fs, xlog
from ..xdr.ledger import (
    LedgerHeaderHistoryEntry,
    TransactionHistoryEntry,
    TransactionHistoryResultEntry,
    TransactionResultSet,
)
from ..util.xdrstream import XDROutputFileStream
from .archive import WELL_KNOWN_PATH, HistoryArchive, HistoryArchiveState
from .filetransfer import (
    CAT_LEDGER,
    CAT_RESULTS,
    CAT_TRANSACTIONS,
    FileTransferInfo,
)

log = xlog.logger("History")

# publish staging kill-points: everything under the publish tmp dir is
# reconstructible (the queue row survives in SQL), so a kill anywhere
# here must repair to "staging reaped at boot, checkpoint republished"
KP_SNAPSHOT = {
    cat: fs.register_durable_site(
        f"publish.snapshot.{cat}", stages=(fs.STAGE_WRITE, fs.STAGE_STAGED),
        doc=f"checkpoint {cat} XDR stream staged for publish",
    )
    for cat in (CAT_LEDGER, CAT_TRANSACTIONS, CAT_RESULTS)
}
KP_STAGE_BUCKET = fs.register_kill_point(
    "publish.stage-bucket", "bucket hard-linked/copied into publish staging"
)
KP_COMMIT_JSON = fs.register_durable_site(
    "publish.commit-json",
    doc="per-archive checkpoint state JSON written for commit",
)


def write_checkpoint_snapshot(app, checkpoint_ledger: int, out_dir: str) -> List[FileTransferInfo]:
    """Write ledger/transactions/results files for the checkpoint range
    (ArchivePublisher::writeNextSnapshot).  Range = (prev checkpoint, this
    checkpoint], clamped to genesis."""
    from ..ledger.headerframe import LedgerHeaderFrame
    from ..tx import history as tx_history

    freq = app.config.CHECKPOINT_FREQUENCY
    first = max(1, (checkpoint_ledger + 1) - freq)

    files = []
    f_ledger = FileTransferInfo.for_checkpoint(out_dir, CAT_LEDGER, checkpoint_ledger)
    f_txs = FileTransferInfo.for_checkpoint(
        out_dir, CAT_TRANSACTIONS, checkpoint_ledger
    )
    f_results = FileTransferInfo.for_checkpoint(out_dir, CAT_RESULTS, checkpoint_ledger)

    db = app.database
    with XDROutputFileStream(
        f_ledger.local_path, durable=True,
        point=KP_SNAPSHOT[CAT_LEDGER], ctx=db,
    ) as lo, XDROutputFileStream(
        f_txs.local_path, durable=True,
        point=KP_SNAPSHOT[CAT_TRANSACTIONS], ctx=db,
    ) as to, XDROutputFileStream(
        f_results.local_path, durable=True,
        point=KP_SNAPSHOT[CAT_RESULTS], ctx=db,
    ) as ro:
        for frame in LedgerHeaderFrame.load_range(
            app.database, first, checkpoint_ledger
        ):
            lo.write_one(
                LedgerHeaderHistoryEntry(frame.get_hash(), frame.header, 0)
            )
            seq = frame.header.ledgerSeq
            rows = tx_history.load_transaction_history(app.database, seq)
            if not rows:
                continue
            # canonical (sorted-by-hash) txset rebuilt from apply-order rows
            from ..herder.txset import TxSetFrame
            from ..tx.frame import TransactionFrame

            prev = LedgerHeaderFrame.load_by_sequence(app.database, seq - 1)
            prev_hash = prev.get_hash() if prev else b"\x00" * 32
            ts = TxSetFrame(prev_hash)
            for env, _res in rows:
                ts.add_transaction(
                    TransactionFrame.make_from_wire(app.network_id, env)
                )
            to.write_one(TransactionHistoryEntry(seq, ts.to_xdr(), 0))
            ro.write_one(
                TransactionHistoryResultEntry(
                    seq, TransactionResultSet([r for _, r in rows]), 0
                )
            )
    files.extend([f_ledger, f_txs, f_results])
    return files


def stage_bucket_files(app, has: HistoryArchiveState, out_dir: str) -> List[FileTransferInfo]:
    """Hard-link/copy every referenced bucket into the staging dir."""
    files = []
    seen = set()  # all_bucket_hashes() repeats hashes shared across levels
    for h in has.all_bucket_hashes():
        if h in seen:
            continue
        seen.add(h)
        fi = FileTransferInfo.for_bucket(out_dir, h)
        src = app.bucket_manager.get_bucket_by_hash(h).path
        if not os.path.exists(fi.local_path):
            try:
                os.link(src, fi.local_path)
            except OSError:
                shutil.copyfile(src, fi.local_path)
            fs.kill_point(
                KP_STAGE_BUCKET, path=fi.local_path, ctx=app.database
            )
        files.append(fi)
    return files


class PublishRun:
    """Publish ONE checkpoint to ALL writable archives, then call done(ok)."""

    def __init__(self, app, checkpoint_ledger: int, state_json: str, done: Callable):
        self.app = app
        self.seq = checkpoint_ledger
        self.has = HistoryArchiveState.from_json(state_json)
        self.state_json = state_json
        self.done = done
        self.archives = [
            HistoryArchive(name, spec)
            for name, spec in app.config.HISTORY.items()
            if spec.get("put")
        ]
        self.tmp = app.tmp_dirs.tmp_dir(f"publish-{checkpoint_ledger}")
        self.files: List[FileTransferInfo] = []
        self._failed = False

    # phase 1+2: snapshot + compress everything once.  The SQL→XDR pass
    # runs on the main crank because the sqlite session is single-threaded
    # (an in-memory DB has no second connection); it covers only one
    # checkpoint range.  The heavy work — bucket staging (hard links) and
    # compression/transfer (subprocesses) — never blocks the crank.
    def start(self) -> None:
        try:
            self.files = write_checkpoint_snapshot(
                self.app, self.seq, self.tmp.get_name()
            )
            self.files += stage_bucket_files(self.app, self.has, self.tmp.get_name())
        except Exception as e:
            log.error("publish %d: snapshot failed: %s", self.seq, e)
            self._finish(False)
            return
        pending = len(self.files)
        if pending == 0:
            self._observe_archives()
            return
        results = {"left": pending, "ok": True}

        def one_done(fi, rc):
            results["left"] -= 1
            if rc != 0:
                log.error("publish %d: gzip failed for %s", self.seq, fi.base_name)
                results["ok"] = False
            if results["left"] == 0:
                if results["ok"]:
                    self._observe_archives()
                else:
                    self._finish(False)

        for fi in self.files:
            self.app.process_manager.run_process(
                f"gzip -c '{fi.local_path}' > '{fi.local_path_gz}'",
                lambda rc, fi=fi: one_done(fi, rc),
            )

    # phase 3..5 per archive, run in parallel across archives
    def _observe_archives(self) -> None:
        if not self.archives:
            self._finish(True)
            return
        counter = {"left": len(self.archives), "ok": True}

        def archive_done(ok):
            counter["left"] -= 1
            counter["ok"] = counter["ok"] and ok
            if counter["left"] == 0:
                self._finish(counter["ok"])

        for ar in self.archives:
            _ArchivePublisher(self, ar, archive_done).start()

    def _finish(self, ok: bool) -> None:
        self.app.tmp_dirs.forget(self.tmp)
        self.done(ok)


class _ArchivePublisher:
    """Phases observe→send→commit against one archive
    (reference ArchivePublisher, PublishStateMachine.h:34-99)."""

    def __init__(self, run: PublishRun, archive: HistoryArchive, done: Callable):
        self.run = run
        self.app = run.app
        self.archive = archive
        self.done = done
        self.remote_state: Optional[HistoryArchiveState] = None

    def start(self) -> None:
        local = os.path.join(
            self.run.tmp.get_name(), f"remote-was-{self.archive.name}.json"
        )
        if not self.archive.has_get():
            self.remote_state = HistoryArchiveState(0)
            self._send()
            return

        def got(rc):
            self.remote_state = HistoryArchiveState(0)
            if rc == 0:
                try:
                    with open(local) as f:
                        self.remote_state = HistoryArchiveState.from_json(f.read())
                except Exception as e:
                    log.info(
                        "archive %s: unreadable remote state (%s); sending all",
                        self.archive.name,
                        e,
                    )
            self._send()

        self.app.process_manager.run_process(
            self.archive.get_file_cmd(WELL_KNOWN_PATH, local), got
        )

    def _send(self) -> None:
        need_hashes = set(
            h.hex() for h in self.run.has.differing_buckets(self.remote_state)
        )
        to_send = [
            fi
            for fi in self.run.files
            if fi.category != "bucket" or fi.base_name[7:-4] in need_hashes
        ]
        counter = {"left": len(to_send), "ok": True}
        if not to_send:
            self._commit()
            return

        def one_done(fi, rc):
            counter["left"] -= 1
            if rc != 0:
                log.error(
                    "archive %s: put failed for %s", self.archive.name, fi.base_name
                )
                counter["ok"] = False
            if counter["left"] == 0:
                if counter["ok"]:
                    self._commit()
                else:
                    self.done(False)

        for fi in to_send:
            self._put(fi.local_path_gz, fi.remote_name, lambda rc, fi=fi: one_done(fi, rc))

    def _put(self, local: str, remote: str, cb) -> None:
        def after_mkdir(_rc):
            self.app.process_manager.run_process(
                self.archive.put_file_cmd(local, remote), cb
            )

        rdir = os.path.dirname(remote)
        if self.archive.has_mkdir() and rdir:
            self.app.process_manager.run_process(
                self.archive.mkdir_cmd(rdir), after_mkdir
            )
        else:
            after_mkdir(0)

    def _commit(self) -> None:
        """Write the per-checkpoint state file then the root .well-known."""
        from .archive import remote_checkpoint_name

        local = os.path.join(
            self.run.tmp.get_name(), f"commit-{self.archive.name}.json"
        )
        fs.durable_write(
            local, self.run.state_json, point=KP_COMMIT_JSON,
            ctx=self.app.database,
        )
        cp_remote = remote_checkpoint_name("history", self.run.seq, ".json")

        def after_cp(rc):
            if rc != 0:
                self.done(False)
                return
            if (
                self.remote_state is not None
                and self.remote_state.current_ledger >= self.run.seq
            ):
                # never regress the archive root (e.g. replay republish)
                self.done(True)
                return
            self._put(
                local,
                WELL_KNOWN_PATH,
                lambda rc2: self.done(rc2 == 0),
            )

        self._put(local, cp_remote, after_cp)
