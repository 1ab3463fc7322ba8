"""Boot self-check & repair — the restart half of the crash-survival
contract (reference anchors: ``checkForMissingBucketsFiles`` +
``downloadMissingBuckets`` at LedgerManagerImpl.cpp:233-247, the
``load_last_known_ledger``/``restore_scp_state`` boot reconciliation,
and the crash-safe publish queue at HistoryManagerImpl.cpp:48-53).

Runs from ``Application.start`` BEFORE the ledger is loaded or the
herder restores SCP state, so every repair lands before anything trusts
the damaged artifact:

1. **Tmp reap** — count the ``publish-*``/``catchup-*`` staging dirs and
   ``tmp-bucket-*``/``.durable-*`` files a killed process left behind
   (TmpDirManager / BucketManager already removed them at construction;
   this meters them as ``selfcheck.tmp-reaped``).
2. **Publish queue** — every queued checkpoint row must parse as a
   HistoryArchiveState; a torn row is dropped (the checkpoint range is
   reconstructible from SQL at the next boundary) rather than left to
   wedge the publish drain forever.
3. **SCP state** — ``lastscpdata`` must decode; undecodable state is
   CLEARED (the node rejoins by hearing consensus) instead of crashing
   the boot loop on every restart.
4. **Header chain** — the ``lastclosedledger`` pointer must name a
   loadable header whose recomputed hash matches; forward rows beyond
   the LCL are truncated.  If the pointer itself is damaged, repair
   rolls BACK to the newest stored header that recomputes to its own
   hash (truncating everything after it, clearing stale SCP state) —
   but only adopts the rollback when the persisted bucket-list state
   still matches that header; otherwise the damage is reported as
   ``corrupt`` and boot fails loudly rather than forking.
5. **Bucket files** — every bucket referenced by the persisted archive
   state or a queued checkpoint is re-hashed; zero-length, truncated,
   bit-flipped, or torn files are QUARANTINED (renamed out of the
   content-addressed namespace) so the existing boot repair path
   (``LedgerManager._repair_missing_buckets`` → history archives)
   treats them as missing and re-downloads, instead of trusting corrupt
   bytes into the bucket list.

Everything is metered on the fast lane (``selfcheck.*``) and the result
is exposed on the ``/selfcheck`` admin route; bench close lines carry
``selfcheck_ms`` so boot-cost regressions stay visible.
"""

from __future__ import annotations

import time
from typing import Optional

from ..util import xlog

log = xlog.logger("Ledger")


def _meter(app, name: str, n: int = 1) -> None:
    if n:
        app.metrics.new_meter(("selfcheck", "boot", name), "item").mark(n)


def run_boot_selfcheck(app, repair: bool = True) -> dict:
    """Verify + repair the node's durable state; returns the report that
    ``/selfcheck`` serves.  ``status`` is ``ok`` (nothing to do),
    ``repaired`` (damage found and fixed), or ``corrupt`` (damage found
    that cannot be repaired locally — boot will fail loudly when the
    damaged artifact is next used).

    ``repair=False`` is the verify-only mode behind ``/selfcheck?rerun=1``
    on a LIVE node: every check runs but nothing is mutated — no rows
    dropped, no state cleared, no bucket quarantined (the boot-time
    re-download path is not available mid-run, so quarantining live
    would turn a readable-but-rotten bucket into a FileNotFoundError on
    the next merge).  Damage is reported in ``problems`` instead; the
    fix is a restart, where the boot pass repairs with the archive
    re-fetch path armed.  The tmp-reap line is skipped (its counters
    describe the BOOT sweep, not this rerun)."""
    t0 = time.perf_counter()
    result = {
        "status": "ok",
        "repairs": [],
        "problems": [],
        "tmp_reaped": 0,
        "buckets_checked": 0,
        "buckets_quarantined": 0,
        "buckets_missing": 0,
        "publish_rows_dropped": 0,
        "headers_truncated": 0,
        "mode": "boot-repair" if repair else "verify-only",
    }
    if repair:
        _check_tmp_reap(app, result)
    _check_publish_queue(app, result, repair)
    _check_scp_state(app, result, repair)
    header = _check_header_chain(app, result, repair)
    _check_bucket_files(app, result, header, repair)
    if result["problems"]:
        result["status"] = "corrupt"
    elif result["repairs"]:
        result["status"] = "repaired"
    result["duration_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    app.metrics.new_timer(("selfcheck", "boot", "run")).update(
        time.perf_counter() - t0
    )
    if result["status"] != "ok":
        log.warning("boot self-check: %s", result)
    else:
        log.info(
            "boot self-check ok: %d bucket(s) verified in %.1f ms",
            result["buckets_checked"],
            result["duration_ms"],
        )
    return result


# -- the individual checks ---------------------------------------------------


def _check_tmp_reap(app, result: dict) -> None:
    reaped = getattr(app.tmp_dirs, "reaped_at_boot", 0) + getattr(
        app.bucket_manager, "tmp_swept_at_boot", 0
    )
    result["tmp_reaped"] = reaped
    if reaped:
        result["repairs"].append(f"reaped {reaped} stale tmp artifact(s)")
        _meter(app, "tmp-reaped", reaped)


def _check_publish_queue(app, result: dict, repair: bool = True) -> None:
    from ..history import publish as publish_queue
    from ..history.archive import HistoryArchiveState

    db = app.database
    try:
        rows = publish_queue.queued_checkpoints(db)
    except Exception:
        return  # no table yet (fresh DB being initialized elsewhere)
    for seq, state_json in rows:
        try:
            HistoryArchiveState.from_json(state_json)
        except Exception:
            if not repair:
                result["problems"].append(
                    f"torn publish-queue row for checkpoint {seq}"
                )
                continue
            publish_queue.dequeue_checkpoint(db, seq)
            result["publish_rows_dropped"] += 1
            result["repairs"].append(
                f"dropped torn publish-queue row for checkpoint {seq}"
            )
    _meter(app, "publish-dropped", result["publish_rows_dropped"])


def _check_scp_state(app, result: dict, repair: bool = True) -> None:
    import base64

    from ..xdr.base import unpack_var_arrays
    from ..xdr.ledger import TransactionSet
    from ..xdr.scp import SCPEnvelope, SCPQuorumSet
    from .persistentstate import K_LAST_SCP_DATA

    raw = app.persistent_state.get_state(K_LAST_SCP_DATA)
    if not raw:
        return
    try:
        blob = base64.b64decode(raw, validate=True)
        unpack_var_arrays(blob, (SCPEnvelope, TransactionSet, SCPQuorumSet))
    except Exception:
        if not repair:
            result["problems"].append("persisted SCP state does not decode")
            return
        app.persistent_state.clear_state(K_LAST_SCP_DATA)
        result["repairs"].append("cleared undecodable persisted SCP state")
        _meter(app, "scp-cleared")


def _check_header_chain(app, result: dict, repair: bool = True):
    """Reconcile lastclosedledger ↔ ledgerheaders; returns the loadable
    LCL header frame (post-repair) or None."""
    from ..ledger.headerframe import LedgerHeaderFrame
    from .persistentstate import (
        K_HISTORY_ARCHIVE_STATE,
        K_LAST_CLOSED_LEDGER,
        K_LAST_SCP_DATA,
    )

    db = app.database
    ps = app.persistent_state
    last = ps.get_state(K_LAST_CLOSED_LEDGER)
    frame = None
    try:
        want = bytes.fromhex(last) if last else None
    except ValueError:
        want = None
    if want is not None:
        frame = LedgerHeaderFrame.load_by_hash(db, want)
        if frame is not None and frame.get_hash() != want:
            frame = None  # stored row does not recompute to its own name
    if frame is None and not repair:
        result["problems"].append(
            "lastclosedledger pointer does not name a consistent stored"
            " header"
        )
        return None
    if frame is None:
        # the pointer (or its row) is damaged: roll back to the newest
        # stored header that recomputes to its own hash
        rows = db.query_all(
            "SELECT ledgerhash, ledgerseq, data FROM ledgerheaders"
            " ORDER BY ledgerseq DESC"
        )
        for lh, seq, data in rows:
            try:
                cand = LedgerHeaderFrame._decode(data)
            except Exception:
                continue
            if cand.get_hash().hex() == lh:
                frame = cand
                break
        if frame is None:
            result["problems"].append(
                "no consistent ledger header found — local repair"
                " impossible (re-init + catchup required)"
            )
            return None
        # only adopt the rollback if the persisted bucket-list state
        # still describes THIS header; otherwise report corrupt
        ok_has = False
        try:
            from ..history.archive import HistoryArchiveState

            has_json = ps.get_state(K_HISTORY_ARCHIVE_STATE)
            if has_json:
                has = HistoryArchiveState.from_json(has_json)
                ok_has = (
                    has.bucket_list_hash() == frame.header.bucketListHash
                )
        except Exception:
            ok_has = False
        if not ok_has:
            result["problems"].append(
                "lastclosedledger pointer damaged and the persisted"
                " bucket-list state does not match any consistent header"
            )
            return None
        ps.set_state(K_LAST_CLOSED_LEDGER, frame.get_hash().hex())
        ps.clear_state(K_LAST_SCP_DATA)
        result["repairs"].append(
            "rolled lastclosedledger back to the last consistent ledger"
            f" {frame.header.ledgerSeq}"
        )
        _meter(app, "lcl-rollback")
    # truncate forward garbage: rows beyond the (possibly repaired) LCL
    # can only come from torn storage — the close writes header + LCL
    # pointer in ONE transaction
    if not repair:
        (n,) = db.query_one(
            "SELECT COUNT(*) FROM ledgerheaders WHERE ledgerseq > ?",
            (frame.header.ledgerSeq,),
        )
        if n:
            result["problems"].append(
                f"{n} header row(s) beyond ledger {frame.header.ledgerSeq}"
            )
        return frame
    cur = db.execute(
        "DELETE FROM ledgerheaders WHERE ledgerseq > ?",
        (frame.header.ledgerSeq,),
    )
    n = cur.rowcount if cur.rowcount and cur.rowcount > 0 else 0
    if n:
        result["headers_truncated"] = n
        result["repairs"].append(
            f"truncated {n} header row(s) beyond ledger"
            f" {frame.header.ledgerSeq}"
        )
        _meter(app, "header-truncated", n)
    return frame


def _check_bucket_files(app, result: dict, header, repair: bool = True) -> None:
    from ..bucket import hashplane
    from ..history import publish as publish_queue
    from ..history.archive import HistoryArchiveState
    from .persistentstate import K_HISTORY_ARCHIVE_STATE

    bm = app.bucket_manager
    states = []
    has_json = app.persistent_state.get_state(K_HISTORY_ARCHIVE_STATE)
    if has_json:
        try:
            states.append(HistoryArchiveState.from_json(has_json))
        except Exception:
            result["problems"].append(
                "persisted history-archive state does not parse"
            )
    try:
        for _seq, state_json in publish_queue.queued_checkpoints(app.database):
            states.append(HistoryArchiveState.from_json(state_json))
    except Exception:
        pass  # torn rows were dropped by _check_publish_queue
    # the full-tree re-hash rides the hash plane (bucket/hashplane.py);
    # the before/after stats delta is this sweep's throughput — the boot
    # report's backend-regression canary (a node silently falling back
    # from device/native to hashlib shows up here first)
    hash_before = hashplane.stats.snapshot()
    verdicts = bm.verify_bucket_files(*states)
    hash_after = hashplane.stats.snapshot()
    result["rehash_mb_per_sec"] = hashplane._Stats.rate_mb_per_sec(
        hash_before, hash_after
    )
    result["rehash_backend"] = (
        hash_after["backend"] or hashplane.get_backend(app.config).name
    )
    result["buckets_checked"] = sum(len(v) for v in verdicts.values())
    for h in verdicts["corrupt"]:
        if not repair:
            # quarantining live would strand the bucket until restart
            # (the re-download path only runs at boot) — report only
            result["problems"].append(
                f"bucket {h.hex()[:16]} fails its content hash"
            )
            continue
        bm.quarantine_bucket_file(h)
        result["buckets_quarantined"] += 1
        result["repairs"].append(
            f"quarantined corrupt bucket {h.hex()[:16]} (will"
            " re-fetch from history)"
        )
    # missing buckets are reported here, repaired by the existing boot
    # path (_repair_missing_buckets downloads from the archives)
    result["buckets_missing"] = len(verdicts["missing"])
    _meter(app, "bucket-quarantined", result["buckets_quarantined"])
    _meter(app, "bucket-missing", result["buckets_missing"])
