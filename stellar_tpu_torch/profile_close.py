#!/usr/bin/env python
"""Profile the steady-state ledger close of the port's node on the card.

    python -m stellar_tpu_torch.profile_close [n_txs] [n_ledgers]          # cProfile a close
    python -m stellar_tpu_torch.profile_close ladder [scale...] [--no-buffer]
    python -m stellar_tpu_torch.profile_close ab [n_txs] [n_ledgers]       # buffer A/B
    python -m stellar_tpu_torch.profile_close fcab [n_txs] [n_ledgers]     # frame-context A/B
    python -m stellar_tpu_torch.profile_close cowab [n_txs] [n_ledgers]    # CoW-snapshot A/B
    python -m stellar_tpu_torch.profile_close --copy-report [n_txs] [n_ledgers]  # xdr_copy sites
    python -m stellar_tpu_torch.profile_close --pipeline-report [n_txs] [n_ledgers]  # close-pipeline A/B
    python -m stellar_tpu_torch.profile_close --apply-report [n_txs] [n_ledgers] [workers]  # parallel-apply A/B
    python -m stellar_tpu_torch.profile_close --assert-budget [ms] [n_txs] # regression gate

The port's twin of the repository's root ``profile_close.py``: the same
modes, arguments, defaults, printed lines and exit codes.  Differences
(ROADMAP, "Recorded contract differences"):

- the node verifies on the gpu backend on ``PROFILE_DEVICE`` (default the
  card; ``cpu`` runs the kernels' plain versions), so every close's txset
  check and flush reaches the verify kernel.  Without CUDA, unless
  ``PROFILE_DEVICE=cpu``, one line naming CUDA goes to stderr and the run
  exits 2 with nothing measured;
- the node's directories are per process (``tx/testutils.get_test_config``);
- where libsodium does not load, the payments are signed with ref25519
  over a spawn process pool: the bytes ``SecretKey.sign`` gives;
- ``--assert-budget``'s leak check looks for ``stellar_tpu_torch.analysis``.

Every close is timed on the host clock around ``check_valid`` and
``close_ledger``; the verdicts of a flush reach the host before
``check_valid`` returns, so the time includes the kernel and its drain.
"""

import cProfile
import io
import os
import pstats
import statistics
import sys
import time

_pool = None  # the signing pool without libsodium (_sign_frames)


def _device() -> str:
    """The device the node verifies on: ``PROFILE_DEVICE`` (default the
    card).  Without CUDA, unless it is ``cpu``: one line on stderr, exit 2."""
    import torch

    name = os.environ.get("PROFILE_DEVICE", "cuda")
    try:
        dev = torch.device(name)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cuda", "cpu"):
        print(f"PROFILE_DEVICE={name!r}: want cuda, cuda:N or cpu", file=sys.stderr)
        sys.exit(2)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(
            "CUDA is not available: the profilers run on the card; set "
            "PROFILE_DEVICE=cpu to run the kernels' plain versions on the CPU",
            file=sys.stderr,
        )
        sys.exit(2)
    return str(dev)


# -- signing without libsodium ----------------------------------------------


def _sign_job(jobs):
    """[(seed, msg)] -> [signature]: ref25519 in a pool worker."""
    from .ops import ref25519 as ref

    return [ref.sign_with_seed(seed, msg) for seed, msg in jobs]


def _close_pool():
    """Shut the signing pool down, if ``_sign_frames`` started one."""
    global _pool
    if _pool is not None:
        _pool.shutdown()
        _pool = None


def _sign_frames(signed):
    """Add each (frame, secret key)'s signature as
    ``TransactionFrame.add_signature`` does, the ref25519 signing (a few
    milliseconds each in Python) spread over a spawn process pool."""
    global _pool
    from .bench import _signing_pool
    from .crypto.keys import PubKeyUtils
    from .xdr.txs import DecoratedSignature

    if _pool is None:
        _pool = _signing_pool()
    jobs = [(sk.get_seed(), frame.get_contents_hash()) for frame, sk in signed]
    parts = [jobs[i : i + 256] for i in range(0, len(jobs), 256)]
    sigs = [s for part in _pool.map(_sign_job, parts) for s in part]
    for (frame, sk), sig in zip(signed, sigs):
        frame.clear_cached()
        frame.envelope.signatures.append(
            DecoratedSignature(PubKeyUtils.get_hint(sk.get_public_key()), sig)
        )


# -- shared close-drive scaffold (used by main, ladder, and ab) -------------


def _make_app(instance, n_txs, buffered=True, frame_context=True, cow=True,
              paranoid=False, pipeline=True, sampled=True, real_time=False,
              parallel_apply=None, apply_workers=None):
    from .main.application import Application
    from .tx import testutils as T
    from .util.clock import REAL_TIME, VirtualClock

    cfg = T.get_test_config(instance, backend="gpu")
    cfg.SIG_DEVICE = _device()
    cfg.DESIRED_MAX_TX_PER_LEDGER = n_txs * 2
    cfg.ENTRY_WRITE_BUFFER = buffered
    cfg.FRAME_CONTEXT = frame_context
    cfg.COW_ENTRY_SNAPSHOTS = cow
    cfg.PARANOID_MODE = paranoid
    cfg.CLOSE_PIPELINE = pipeline
    if parallel_apply is not None:
        cfg.PARALLEL_APPLY = parallel_apply
    if apply_workers is not None:
        cfg.APPLY_WORKERS = apply_workers
    # the invariant plane SAMPLED, as the bench's close runs it;
    # --pipeline-report and --apply-report ask for ALL-ON
    cfg.INVARIANT_SAMPLED = sampled
    # span durations need a real clock (a virtual one stamps every span
    # with an unmoving now()); only the trace-reading modes ask for it
    clock = VirtualClock(REAL_TIME) if real_time else VirtualClock()
    return Application.create(clock, cfg, new_db=True), clock


def _max_txset_upgrade(n_txs):
    from .xdr.base import xdr_to_opaque
    from .xdr.ledger import LedgerUpgrade, LedgerUpgradeType

    return xdr_to_opaque(
        LedgerUpgrade(LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE, n_txs * 2)
    )


def _drive_close(app, txs, upgrades=()):
    """sort_for_hash + check_valid + close_ledger for one txset.

    Returns (total_s, close_s): total includes check_valid (what a node
    pays end-to-end), close_s is close_ledger alone."""
    from .herder.ledgerclose import LedgerCloseData
    from .herder.txset import TxSetFrame
    from .xdr.ledger import StellarValue

    lm = app.ledger_manager
    txset = TxSetFrame(lm.last_closed.hash, list(txs))
    txset.sort_for_hash()
    t0 = time.perf_counter()
    ok = txset.check_valid(app)
    sv = StellarValue(
        txset.get_contents_hash(),
        lm.last_closed.header.scpValue.closeTime + 5,
        list(upgrades),
        0,
    )
    t1 = time.perf_counter()
    lm.close_ledger(LedgerCloseData(lm.current.header.ledgerSeq, txset, sv))
    t2 = time.perf_counter()
    assert ok
    return t2 - t0, t2 - t1


def _populate(app, accounts, n_txs):
    """Create `accounts` through real closes (100-op create txs, 2000 per
    close), applying the max-txset upgrade on the first close.  Returns
    {strkey: creation ledger seq} for payment seq-num math."""
    from .ledger.accountframe import AccountFrame
    from .tx import testutils as T

    lm = app.ledger_manager
    root = T.root_key_for(app)
    seq = AccountFrame.load_account(
        root.get_public_key(), app.database
    ).get_seq_num()
    upgrades = [_max_txset_upgrade(n_txs)]
    created_at = {}
    for start in range(0, len(accounts), 2000):
        batch = accounts[start : start + 2000]
        txs = []
        for i in range(0, len(batch), 100):
            seq += 1
            txs.append(
                T.tx_from_ops(
                    app, root, seq,
                    [T.create_account_op(a, 10**10) for a in batch[i : i + 100]],
                )
            )
        _drive_close(app, txs, upgrades)
        upgrades = []
        for a in batch:
            created_at[a.get_strkey_public()] = lm.last_closed.header.ledgerSeq
    return created_at


def _payment_txs(app, accounts, created_at, n_txs, round_no, dest_of=None):
    """One payment tx per source account; `dest_of(i)` returns the dest
    PublicKey (defaults to the next account in the list).  Signed with
    libsodium in process, else over the signing pool."""
    from . import xdr as X
    from .crypto import sodium
    from .tx import testutils as T
    from .tx.frame import TransactionFrame

    in_process = sodium.available()
    fee = app.ledger_manager.get_tx_fee()
    txs, unsigned = [], []
    for i in range(n_txs):
        src = accounts[i]
        dest_pk = (
            dest_of(i) if dest_of is not None
            else accounts[i + 1].get_public_key()
        )
        s = (created_at[src.get_strkey_public()] << 32) + 1 + round_no
        op = T.op(
            X.OperationType.PAYMENT,
            X.PaymentOp(dest_pk, X.Asset.native(), 1000),
        )
        if in_process:
            txs.append(T.tx_from_ops(app, src, s, [op]))
            continue
        # tx_from_ops' transaction, signed below
        tx = X.Transaction(sourceAccount=src.get_public_key(), fee=fee, seqNum=s,
                           timeBounds=None, memo=X.Memo.none(), operations=[op], ext=0)
        txs.append(TransactionFrame(app.network_id, X.TransactionEnvelope(tx, [])))
        unsigned.append((txs[-1], src))
    if unsigned:
        _sign_frames(unsigned)
    return txs


# -- modes ------------------------------------------------------------------


def main(n_txs=1000, n_ledgers=3):
    from .tx import testutils as T

    app, clock = _make_app(96, n_txs)
    try:
        accounts = [T.get_account(i + 1) for i in range(n_txs + 1)]
        created_at = _populate(app, accounts, n_txs)

        pr = cProfile.Profile()
        times = []
        for j in range(n_ledgers):
            txs = _payment_txs(app, accounts, created_at, n_txs, j)
            pr.enable()
            total_s, _close_s = _drive_close(app, txs)
            pr.disable()
            times.append(total_s)
        print(
            f"p50 {statistics.median(times) * 1e3:.0f} ms over {n_ledgers} "
            f"closes of {n_txs} txs (incl check_valid; profiler overhead incl.)"
        )
        for sort in ("cumulative", "tottime"):
            s = io.StringIO()
            pstats.Stats(pr, stream=s).sort_stats(sort).print_stats(30)
            body = s.getvalue()
            # drop the boilerplate header lines
            print("\n".join(body.splitlines()[:40]))
        # focused accounting: these functions fall out of the top-30 as
        # they get cheap, so grep-able exact numbers beat the tables
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(
            r"load_account|metrics\.py|framecontext"
        )
        print("== focused (load_account / metrics / framecontext) ==")
        print("\n".join(
            l for l in s.getvalue().splitlines()
            if "/" in l or "ncalls" in l
        ))
    finally:
        app.graceful_stop()
        clock.shutdown()


def ladder(scales=(10**4, 10**5, 10**6), n_txs=5000, n_ledgers=3,
           buffered=True):
    """Account-scale close ladder (reference shape:
    LedgerPerformanceTests.cpp:149-225 — pre-create accounts, time the
    close loop at each scale).

    Each rung pre-populates `scale` accounts: n_txs + 1 real-keyed payment
    participants plus synthetic bulk rows inserted directly (the reference
    also pre-creates state outside the timed loop).  Payment destinations
    are drawn uniformly from the WHOLE account range, so at 10^6 the
    working set exceeds the 131,072-entry cache and the rung measures
    cache-thrash + SQL load behavior, not just apply cost.  Returns
    [(scale, p50 s, cache hit rate, populate s)]."""
    import base64
    import random

    from .crypto import strkey
    from .ledger.entryframe import entry_cache_of
    from .tx import testutils as T
    from .xdr.xtypes import PublicKey

    thresholds_b64 = base64.b64encode(b"\x01\x00\x00\x00").decode()
    results = []
    for scale in scales:
        app, clock = _make_app(95, n_txs, buffered=buffered)
        try:
            srcs = [T.get_account(i + 1) for i in range(n_txs + 1)]
            created_at = _populate(app, srcs, n_txs)

            # synthetic bulk rows straight into the accounts table
            n_synth = max(0, scale - len(srcs))
            t0 = time.perf_counter()
            rows = [
                (
                    strkey.to_account_strkey(
                        (0x5A000000 + i).to_bytes(32, "big")
                    ),
                    10**9, 1, 0, None, "", thresholds_b64, 0, 1,
                )
                for i in range(n_synth)
            ]
            with app.database.transaction():
                app.database.executemany(
                    """INSERT INTO accounts (accountid, balance, seqnum,
                       numsubentries, inflationdest, homedomain, thresholds,
                       flags, lastmodified) VALUES (?,?,?,?,?,?,?,?,?)""",
                    rows,
                )
            populate_s = time.perf_counter() - t0
            synth_pks = [
                PublicKey.from_ed25519(strkey.from_account_strkey(r[0]))
                for r in rows
            ]

            rng = random.Random(42)
            cache = entry_cache_of(app.database)
            times = []
            cache.hits = cache.misses = 0
            dest_of = (
                (lambda i: rng.choice(synth_pks)) if synth_pks else None
            )
            for j in range(n_ledgers):
                txs = _payment_txs(app, srcs, created_at, n_txs, j, dest_of)
                total_s, _close_s = _drive_close(app, txs)
                times.append(total_s)
            hit_rate = cache.hits / max(1, cache.hits + cache.misses)
            p50 = statistics.median(times)
            results.append((scale, p50, hit_rate, populate_s))
            print(
                f"scale {scale:>9,}: p50 {p50 * 1e3:7.0f} ms  "
                f"cache hit rate {hit_rate * 100:5.1f}%  "
                f"(populate {populate_s:.1f}s)",
                flush=True,
            )
        finally:
            app.graceful_stop()
            clock.shutdown()
    return results


def _timed_close_run(instance, n_txs, n_ledgers, **make_app_kwargs):
    """THE clean-close drive every measurement mode shares: populate,
    close `n_ledgers` payment sets, return (close-only p50, final ledger
    hash).  One copy so the A/B legs can never drift apart in workload."""
    from .tx import testutils as T

    app, clock = _make_app(instance, n_txs, **make_app_kwargs)
    try:
        accounts = [T.get_account(i + 1) for i in range(n_txs + 1)]
        created_at = _populate(app, accounts, n_txs)
        times = []
        for j in range(n_ledgers):
            txs = _payment_txs(app, accounts, created_at, n_txs, j)
            _total_s, close_s = _drive_close(app, txs)
            times.append(close_s)
        return statistics.median(times), app.ledger_manager.last_closed.hash
    finally:
        app.graceful_stop()
        clock.shutdown()


def _knob_ab(knob, label, n_txs, n_ledgers, instances, **extra):
    """On/off A/B over one _make_app kwarg: prints both close-only p50s
    and asserts the final ledger hashes match.  Pair samples within one
    run: a host's speed drifts between runs."""
    p50_on, h_on = _timed_close_run(
        instances[0], n_txs, n_ledgers, **{knob: True}, **extra
    )
    p50_off, h_off = _timed_close_run(
        instances[1], n_txs, n_ledgers, **{knob: False}, **extra
    )
    print(
        f"{label} on:  close p50 {p50_on * 1e3:.0f} ms\n"
        f"{label} off: close p50 {p50_off * 1e3:.0f} ms"
    )
    assert h_on == h_off, f"ledger hash diverged between {label} modes!"
    print("final ledger hashes match")


def ab(n_txs=5000, n_ledgers=5):
    """ENTRY_WRITE_BUFFER A/B."""
    _knob_ab("buffered", "ENTRY_WRITE_BUFFER", n_txs, n_ledgers, (97, 98))


def fcab(n_txs=5000, n_ledgers=5):
    """FRAME_CONTEXT A/B."""
    _knob_ab("frame_context", "FRAME_CONTEXT", n_txs, n_ledgers, (93, 94))


def cowab(n_txs=5000, n_ledgers=5):
    """COW_ENTRY_SNAPSHOTS A/B — PARANOID on BOTH sides: every close's
    delta is audited against SQL in both modes, and the final ledger
    hashes must match bit-exactly."""
    _knob_ab(
        "cow", "COW_ENTRY_SNAPSHOTS", n_txs, n_ledgers, (90, 91),
        paranoid=True,
    )


def copy_report(n_txs=5000, n_ledgers=3, both=True):
    """Per-call-site xdr_copy attribution.  Runs the standard paired drive
    under cProfile with the CoW plane on (and, with `both`, a CoW-off leg
    in the same run), then prints every call site that reaches xdr_copy
    with its call count and calls/tx, plus the seal/CoW-copy counters.
    Final ledger hashes of the two legs are asserted equal."""
    from .ledger.entryframe import cow_stats
    from .xdr.base import xdr_copy_calls

    def leg(instance, cow):
        from .tx import testutils as T

        app, clock = _make_app(instance, n_txs, cow=cow)
        try:
            accounts = [T.get_account(i + 1) for i in range(n_txs + 1)]
            created_at = _populate(app, accounts, n_txs)
            pr = cProfile.Profile()
            d_copies = d_seals = d_unseals = 0
            for j in range(n_ledgers):
                txs = _payment_txs(app, accounts, created_at, n_txs, j)
                # sample the counters around the PROFILED close only, so
                # the headline copies/tx covers exactly the window the
                # per-site pstats rows attribute (tx building above also
                # calls xdr_copy and must stay outside both)
                copies0, cow0 = xdr_copy_calls(), cow_stats()
                pr.enable()
                _drive_close(app, txs)
                pr.disable()
                cow1 = cow_stats()
                d_copies += xdr_copy_calls() - copies0
                d_seals += cow1["seals"] - cow0["seals"]
                d_unseals += cow1["unseals"] - cow0["unseals"]
            return (
                pr, d_copies, d_seals, d_unseals,
                app.ledger_manager.last_closed.hash,
            )
        finally:
            app.graceful_stop()
            clock.shutdown()

    def report(tag, pr, d_copies, d_seals, d_unseals):
        n_applied = n_txs * n_ledgers
        print(
            f"\n== {tag}: xdr_copy {d_copies} calls over {n_ledgers} closes"
            f" of {n_txs} txs = {d_copies / n_applied:.2f}/tx"
            f"  (seals {d_seals / n_applied:.2f}/tx,"
            f" CoW copies paid {d_unseals / n_applied:.2f}/tx) =="
        )
        stats = pstats.Stats(pr).stats
        rows = []
        for func, (_cc, _nc, _tt, _ct, callers) in stats.items():
            if func[2] != "xdr_copy":
                continue
            for site, (_scc, snc, _stt, _sct) in callers.items():
                rows.append((snc, f"{site[0].split('/')[-1]}:{site[1]}"
                                  f" {site[2]}"))
        rows.sort(reverse=True)
        for calls, site in rows:
            print(f"  {calls:>9,}  {calls / n_applied:6.2f}/tx  {site}")

    on = leg(88, True)
    report("CoW ON", *on[:4])
    if both:
        off = leg(89, False)
        report("CoW OFF", *off[:4])
        assert on[4] == off[4], "ledger hash diverged between CoW modes!"
        print("\nfinal ledger hashes match")


def pipeline_report(n_txs=5000, n_ledgers=3, both=True):
    """Paired CLOSE_PIPELINE on/off A/B with per-phase overlap accounting.
    Both legs run PARANOID with the invariant plane ALL-ON and drive the
    same payment closes; the ON leg registers round j+1's tx bag as a
    prewarm candidate before round j closes (the herder hand-off seam,
    ledger/closepipeline.py), so the signature verify for j+1 runs on the
    card while j applies.  Prints, per leg, the close-phase p50s plus the
    pipeline's own overlap ledger (dispatched/joined/warm, hidden ms,
    join-wait ms), then the residual sig-verify cost inside the close both
    ways and the reduction (exit 1 below 80 %).  Ledger hashes, SQL dumps,
    and tx/fee-history metas are asserted bit-exact between legs."""
    from .tx import testutils as T

    def leg(instance, pipeline):
        app, clock = _make_app(
            instance, n_txs, pipeline=pipeline, paranoid=True,
            sampled=False, real_time=True,
        )
        try:
            accounts = [T.get_account(i + 1) for i in range(n_txs + 1)]
            created_at = _populate(app, accounts, n_txs)
            # tx bags carry no ledger linkage — build every round up
            # front so the ON leg can register j+1 before j closes
            round_txs = [
                _payment_txs(app, accounts, created_at, n_txs, j)
                for j in range(n_ledgers)
            ]
            app.tracer.clear()  # spans must describe ONLY the timed closes
            # the verify cache is process-global: the legs drive IDENTICAL
            # txs, so leg A would warm leg B's flushes and fake its
            # residual to ~0.  Each leg starts cold.
            from .crypto.keys import PubKeyUtils

            PubKeyUtils.clear_verify_sig_cache()
            pipe = app.close_pipeline if pipeline else None
            times = []
            for j in range(n_ledgers):
                if pipe is not None and j + 1 < n_ledgers:
                    pipe.note_upcoming(round_txs[j + 1])
                total_s, _close_s = _drive_close(app, round_txs[j])
                times.append(total_s)
            agg = app.tracer.aggregates()
            phases = {
                name: round(agg[name]["p50_ms"], 2)
                for name in (
                    "ledger.close", "close.sig_flush", "close.fees",
                    "close.apply", "close.commit", "close.pipeline.dispatch",
                    "close.pipeline.join", "txset.validate", "sig.flush",
                )
                if name in agg
            }
            stats = pipe.stats() if pipe is not None else None
            inv = app.invariants
            assert inv.total_violations == 0, inv.dump_info()
            assert inv.closes_checked >= n_ledgers
            return (
                statistics.median(times), phases, stats,
                app.ledger_manager.last_closed.hash,
                T.dump_state(app.database),  # the shared bit-exactness oracle
            )
        finally:
            app.graceful_stop()
            clock.shutdown()

    def residual_ms(phases, stats):
        """The sig-verify wall the externalize→close path pays
        SYNCHRONOUSLY per ledger.  The check_valid prewarm's flush
        (sig.flush span: the full batch verify inline; an all-hit cache
        peek once the pipeline prewarmed it) plus the close's own
        sig_flush — the join wait when pipelined, whatever the nested fee
        pass did not hide when inline."""
        flush = phases.get("sig.flush", 0.0)
        if stats is not None:
            return flush + phases.get("close.sig_flush", 0.0)
        return flush + max(
            0.0,
            phases.get("close.sig_flush", 0.0) - phases.get("close.fees", 0.0),
        )

    def report(tag, p50, phases, stats):
        print(f"\n== pipeline {tag}: total p50 {p50 * 1e3:.0f} ms over"
              f" {n_ledgers} closes of {n_txs} txs ==")
        for name, ms in sorted(phases.items()):
            print(f"  {name:<24} {ms:>9.2f} ms p50")
        print(f"  sig-verify residual in close: {residual_ms(phases, stats):.2f} ms p50")
        if stats is not None:
            print(
                f"  pipeline: dispatched {stats['dispatched']},"
                f" joined {stats['joined']} (warm {stats['joined_warm']}),"
                f" quarantined {stats['quarantined']},"
                f" hidden {stats['overlap_hidden_ms']:.1f} ms,"
                f" join wait {stats['join_wait_ms']:.1f} ms,"
                f" dispatch {stats['dispatch_ms']:.1f} ms"
            )

    p50_on, ph_on, st_on, h_on, sql_on = leg(86, True)
    report("ON", p50_on, ph_on, st_on)
    if not both:
        return 0
    p50_off, ph_off, st_off, h_off, sql_off = leg(87, False)
    report("OFF", p50_off, ph_off, st_off)
    assert h_on == h_off, "ledger hash diverged between pipeline modes!"
    assert sql_on == sql_off, (
        "SQL state (entries or history metas) diverged between pipeline modes!"
    )
    print("\nfinal ledger hashes + SQL dumps + history metas bit-exact")
    r_on, r_off = residual_ms(ph_on, st_on), residual_ms(ph_off, st_off)
    if r_off > 0:
        red = 100.0 * (1.0 - r_on / r_off)
        print(
            f"residual sig-verify inside close: {r_off:.2f} ms -> "
            f"{r_on:.2f} ms ({red:.0f}% reduction; acceptance >= 80%)"
        )
        return 0 if red >= 80.0 else 1
    print("off-leg residual ~0 (fees already hid the flush at this scale)")
    return 0


def apply_report(n_txs=5000, n_ledgers=3, workers=4, both=True):
    """Paired PARALLEL_APPLY on/off A/B.

    Both legs run PARANOID with the invariant plane ALL-ON and drive the
    SAME payment closes in the same run; destinations pair off
    (src[i] -> src[i^1]) so the footprint partitioner finds n_txs/2
    disjoint two-tx groups.  Prints, per leg, the close-phase p50s (with
    the scheduler's apply.partition / apply.group / apply.merge spans on
    the ON leg) and the per-shard occupancy table from the scheduler's
    last-close ledger, then asserts ledger hashes, SQL dumps, and
    tx/fee-history metas bit-exact between legs and reports the
    apply-phase wall ratio (gated at >= 1.5x on a host of 4 cores or
    more).  Exit 1 when the parallel leg never sharded a close."""
    from .tx import testutils as T

    def leg(instance, parallel):
        app, clock = _make_app(
            instance, n_txs, paranoid=True, sampled=False, real_time=True,
            parallel_apply=parallel, apply_workers=workers,
        )
        try:
            accounts = [T.get_account(i + 1) for i in range(n_txs + 1)]
            created_at = _populate(app, accounts, n_txs)
            # pair sources off so footprints are disjoint: a chain
            # (i -> i+1) union-finds into ONE group and schedules serial
            dest_of = lambda i: accounts[i ^ 1].get_public_key()
            round_txs = [
                _payment_txs(app, accounts, created_at, n_txs, j,
                             dest_of=dest_of)
                for j in range(n_ledgers)
            ]
            app.tracer.clear()  # spans must describe ONLY the timed closes
            from .crypto.keys import PubKeyUtils

            PubKeyUtils.clear_verify_sig_cache()  # each leg starts cold
            times = []
            for j in range(n_ledgers):
                _total_s, close_s = _drive_close(app, round_txs[j])
                times.append(close_s)
            agg = app.tracer.aggregates()
            phases = {
                name: round(agg[name]["p50_ms"], 2)
                for name in (
                    "ledger.close", "close.fees", "close.apply",
                    "close.commit", "apply.partition", "apply.group",
                    "apply.merge",
                )
                if name in agg
            }
            sched = getattr(app.ledger_manager, "_apply_sched", None)
            stats = dict(sched.stats) if sched is not None else None
            last = sched.last_close if sched is not None else None
            inv = app.invariants
            assert inv.total_violations == 0, inv.dump_info()
            assert inv.closes_checked >= n_ledgers
            return (
                statistics.median(times), phases, stats, last,
                app.ledger_manager.last_closed.hash,
                T.dump_state(app.database),  # the shared bit-exactness oracle
            )
        finally:
            app.graceful_stop()
            clock.shutdown()

    def report(tag, p50, phases, stats, last):
        print(f"\n== parallel apply {tag}: close p50 {p50 * 1e3:.0f} ms"
              f" over {n_ledgers} closes of {n_txs} txs ==")
        for name, ms in sorted(phases.items()):
            print(f"  {name:<24} {ms:>9.2f} ms p50")
        if stats is not None:
            total = stats["total_txs"] or 1
            print(
                f"  scheduler: {stats['closes_parallel']} parallel /"
                f" {stats['closes_serial']} serial closes,"
                f" {100.0 * stats['parallel_txs'] / total:.1f}% of txs in"
                f" parallel groups, {stats['conflict_fallbacks']}"
                f" conflict fallbacks, {stats['escapes']} escapes"
            )
        if last is not None and last.get("mode") == "parallel":
            sizes = last["group_sizes"]
            shard_txs = last["shard_txs"]
            peak = max(shard_txs)
            print(
                f"  last close: {last['txs']} txs -> {last['groups']}"
                f" disjoint groups (sizes min/med/max "
                f"{min(sizes)}/{sorted(sizes)[len(sizes) // 2]}/{max(sizes)})"
                f" on {last['workers']} shards"
            )
            for i, n in enumerate(shard_txs):
                bar = "#" * int(30 * n / peak) if peak else ""
                print(f"    shard {i}: {n:>6} txs {bar}")
            print(
                f"  shard occupancy {100.0 * sum(shard_txs) / (peak * len(shard_txs)):.0f}%"
                f" (sum/peak*shards — 100% = perfectly balanced)"
            )

    p50_on, ph_on, st_on, last_on, h_on, sql_on = leg(82, True)
    report("ON", p50_on, ph_on, st_on, last_on)
    if not both:
        return 0
    p50_off, ph_off, st_off, _last_off, h_off, sql_off = leg(83, False)
    report("OFF", p50_off, ph_off, st_off, None)
    assert h_on == h_off, "ledger hash diverged between apply modes!"
    assert sql_on == sql_off, (
        "SQL state (entries or history metas) diverged between apply modes!"
    )
    print("\nfinal ledger hashes + SQL dumps + history metas bit-exact")
    if st_on is None or st_on["closes_parallel"] == 0:
        print("parallel leg never sharded a close — nothing was certified")
        return 1
    a_on = ph_on.get("close.apply", 0.0)
    a_off = ph_off.get("close.apply", 0.0)
    if a_on > 0:
        cores = os.cpu_count() or 1
        ratio = a_off / a_on
        print(
            f"apply-phase wall: {a_off:.2f} ms serial -> {a_on:.2f} ms"
            f" with {st_on['workers']} workers ({ratio:.2f}x) on a"
            f" {cores}-core host"
        )
        if cores >= 4:
            return 0 if ratio >= 1.5 else 1
        print(
            "single/dual-core host: wall ratio is GIL-bound by"
            " construction; per-call accounting above is the evidence"
            " (acceptance ratio reads against a multi-core host)"
        )
    return 0


def assert_budget(budget_ms=2000.0, n_txs=5000, n_ledgers=3):
    """Close-regression gate: clean (unprofiled) close-only p50 of the
    standard close drive, exit 1 when it exceeds the budget (default the
    JAX harness's 2000 ms) or when the static-analysis package is loaded
    in the close path's process."""
    p50, _h = _timed_close_run(92, n_txs, n_ledgers)
    ok = p50 * 1e3 <= budget_ms
    print(
        f"close p50 {p50 * 1e3:.0f} ms over {n_ledgers} closes of "
        f"{n_txs} txs — budget {budget_ms:.0f} ms: "
        f"{'OK' if ok else 'EXCEEDED'}"
    )
    # the static-analysis plane is build/test-time ONLY: if the close path
    # ever grows an import of stellar_tpu_torch.analysis, its runtime cost
    # is no longer zero and this gate stops certifying that claim
    analysis_mods = [
        m for m in sys.modules if m.startswith("stellar_tpu_torch.analysis")
    ]
    if analysis_mods:
        print(
            "BUDGET GATE: stellar_tpu_torch.analysis leaked into the close-path"
            f" runtime ({analysis_mods}) — it must stay build/test-time only"
        )
        return 1
    print("analysis plane: not imported by the close path (0 ms, by construction)")
    return 0 if ok else 1


def _cli(args) -> int:
    _device()  # no card, no run: exit 2 before anything is measured
    if args and args[0] == "ladder":
        buffered = "--no-buffer" not in args
        scales_args = [a for a in args[1:] if a != "--no-buffer"]
        scales = (
            tuple(int(s) for s in scales_args)
            if scales_args
            else (10**4, 10**5, 10**6)
        )
        ladder(scales, buffered=buffered)
    elif args and args[0] in ("ab", "fcab", "cowab"):
        {"ab": ab, "fcab": fcab, "cowab": cowab}[args[0]](
            int(args[1]) if len(args) > 1 else 5000,
            int(args[2]) if len(args) > 2 else 5,
        )
    elif args and args[0] == "--copy-report":
        rest = [a for a in args[1:] if a != "--single"]
        copy_report(
            int(rest[0]) if rest else 5000,
            int(rest[1]) if len(rest) > 1 else 3,
            both="--single" not in args,
        )
    elif args and args[0] == "--apply-report":
        rest = [a for a in args[1:] if a != "--single"]
        return apply_report(
            int(rest[0]) if rest else 5000,
            int(rest[1]) if len(rest) > 1 else 3,
            int(rest[2]) if len(rest) > 2 else 4,
            both="--single" not in args,
        )
    elif args and args[0] == "--pipeline-report":
        rest = [a for a in args[1:] if a != "--single"]
        return pipeline_report(
            int(rest[0]) if rest else 5000,
            int(rest[1]) if len(rest) > 1 else 3,
            both="--single" not in args,
        )
    elif args and args[0] == "--assert-budget":
        return assert_budget(
            float(args[1]) if len(args) > 1 else 2000.0,
            int(args[2]) if len(args) > 2 else 5000,
        )
    else:
        main(
            int(args[0]) if args else 1000,
            int(args[1]) if len(args) > 1 else 3,
        )
    return 0


if __name__ == "__main__":
    try:
        rc = _cli(sys.argv[1:])
    finally:
        _close_pool()
    sys.exit(rc)
