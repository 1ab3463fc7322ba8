#!/usr/bin/env python
"""System-level throughput harnesses of the port, on the card.

    python -m stellar_tpu_torch.profile_system bucket [n]            # [bucketbench] shape
    python -m stellar_tpu_torch.profile_system autoload [n_txs] [mix]  # [autoload] shape
    python -m stellar_tpu_torch.profile_system ladder [max_rung]     # the state ladder
    python -m stellar_tpu_torch.profile_system hash_ab [mb]          # device-vs-host A/B

The port's twin of the repository's root ``profile_system.py``: the same
modes, arguments, defaults, printed lines and exit codes.

bucket: write two fresh n-entry buckets, then merge them through the
native C engine (BucketTests.cpp:399 'file-backed buckets' flavor).
autoload: auto-calibrated single-node load through FULL consensus
(CoreTests.cpp:294; accelerated cadence, virtual clock), reporting real
applied tx/s.  mix = payments | full (LoadGenerator.cpp:664-684 shapes).
ladder: the 10^4/10^5/10^6-account state-plane ladder
(LedgerPerformanceTests.cpp:149-225 scale): seed the bucket list to the
rung, run LoadGenerator-shaped payment closes on top (close p50 — spill
merges ride the background worker, bucket/mergeworker.py), time a
representative two-bucket merge, then the catchup-from-archive leg
(full-tree re-hash from disk) and per-backend bit-identity on every
bucket the rung produced; exit 1 when the top rung's close p50 exceeds
1.5x the bottom's.  Writes STATE_LADDER_torch.json in the working
directory.
hash_ab: one framed buffer through the host backend and the device
kernel (B3, ``csrc/sha256_frames.cu``); exits 1 when the device leg is
below 2x host throughput: the exit code is a speed verdict.

Differences from ``profile_system.py`` (ROADMAP, "Recorded contract
differences"): the node verifies on the gpu backend and the device bucket
backend runs on ``PROFILE_DEVICE`` (default the card; ``cpu`` runs the
kernels' plain versions; without CUDA, unless ``PROFILE_DEVICE=cpu``, one
line naming CUDA on stderr and exit 2 with nothing measured, also for
``hash_ab``); the ladder writes STATE_LADDER_torch.json (not the JAX
package's STATE_LADDER_r22.json) with the device's name beside ``cpus``;
the device backend is named ``device-cuda`` (``device-cpu``), not
``device-xla``.  A device leg that fails to build or launch ends the run:
no leg falls back to another backend.
"""

import json
import random
import statistics
import sys
import time

from .profile_close import _device


def bucket(n=100_000):
    from .bucket.bucket import Bucket
    from .ledger.entryframe import ledger_key_of
    from .main.application import Application
    from .tx import testutils as T
    from .util.clock import VirtualClock
    from .xdr.arbitrary import arbitrary_of
    from .xdr.ledger import LedgerEntry

    cfg = T.get_test_config(95)
    cfg.SIG_DEVICE = _device()
    clock = VirtualClock()
    app = Application.create(clock, cfg, new_db=True)
    bm = app.bucket_manager
    rng = random.Random(7)
    try:
        live1 = [arbitrary_of(LedgerEntry, rng=rng) for _ in range(n)]
        live2 = [arbitrary_of(LedgerEntry, rng=rng) for _ in range(n)]

        t0 = time.perf_counter()
        b1 = Bucket.fresh(bm, live1, [])
        b2 = Bucket.fresh(bm, live2, [ledger_key_of(e) for e in live1[: n // 10]])
        t_write = time.perf_counter() - t0

        t0 = time.perf_counter()
        Bucket.merge(bm, b1, b2)
        t_merge = time.perf_counter() - t0
        total_in = 2 * n + n // 10
        from . import native

        engine = "C" if native.available() else "PYTHON-FALLBACK"
        print(
            f"n={n}/bucket: fresh-write {2 * n / t_write:,.0f} entries/s "
            f"({t_write:.2f}s); {engine} merge {total_in / t_merge:,.0f} "
            f"entries/s ({t_merge:.2f}s, {total_in} entries in)"
        )
    finally:
        app.graceful_stop()
        clock.shutdown()


def autoload(n_txs=30_000, mix="payments"):
    from .main.application import Application
    from .simulation.loadgen import LoadGenerator
    from .tx import testutils as T
    from .util.clock import VIRTUAL_TIME, VirtualClock

    n_accounts = max(100, n_txs // 60)
    clock = VirtualClock(VIRTUAL_TIME)
    cfg = T.get_test_config(96)
    cfg.SIG_DEVICE = _device()
    cfg.MANUAL_CLOSE = False
    cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = True
    cfg.DESIRED_MAX_TX_PER_LEDGER = 10000
    app = Application.create(clock, cfg, new_db=True)
    try:
        app.herder.bootstrap()
        app.ledger_manager.current.header.maxTxSetSize = 10000
        gen = LoadGenerator()
        gen.generate_load(app, n_accounts, n_txs, 10, auto_rate=True, mix=mix)
        total = n_accounts + n_txs
        applied = app.metrics.new_meter(("ledger", "transaction", "count"), "tx")
        t0 = time.perf_counter()
        # time until the txs are IN CLOSED LEDGERS (the apply meter), not
        # merely accepted by the herder — "applied tx/s" means applied
        ok = clock.crank_until(
            lambda: gen.is_done() and applied.count >= total, 1800
        )
        wall = time.perf_counter() - t0
        done = min(total, applied.count)  # on timeout: only what landed
        print(
            f"mix={mix}: done={ok} {done}/{total} txs applied in "
            f"{wall:.1f}s real = {done / wall:,.0f} tx/s end-to-end over "
            f"{app.ledger_manager.get_last_closed_ledger_num()} ledgers "
            f"(calibrated offered rate {gen.rate}/s)"
        )
    finally:
        app.graceful_stop()
        clock.shutdown()


def _ladder_account(i: int, balance: int = 1_000_000):
    """Cheap deterministic account entry #i (distinct pk per index)."""
    from .xdr.entries import (
        AccountEntry,
        LedgerEntry,
        LedgerEntryData,
        LedgerEntryType,
        PublicKey,
    )

    pk = PublicKey.from_ed25519(i.to_bytes(8, "big") + b"\x5a" * 24)
    ae = AccountEntry(
        accountID=pk,
        balance=balance + i,
        seqNum=1,
        numSubEntries=0,
        inflationDest=None,
        flags=0,
        homeDomain="",
        thresholds=b"\x01\x00\x00\x00",
        signers=[],
        ext=0,
    )
    return LedgerEntry(0, LedgerEntryData(LedgerEntryType.ACCOUNT, ae), 0)


def _rung(n: int, traffic_closes: int = 12, txs_per_close: int = 50,
          device_byte_budget: int = 256 << 20) -> dict:
    """One ladder rung: seed the bucket list to n accounts, run
    LoadGenerator-shaped payment closes on top, then the merge/catchup/
    backend-identity legs.  Returns the rung's metric dict."""
    from .bucket import hashplane
    from .bucket.bucket import Bucket
    from .main.application import Application
    from .tx import testutils as T
    from .util.clock import VirtualClock

    device = _device()
    cfg = T.get_test_config(97)
    cfg.SIG_DEVICE = device
    clock = VirtualClock()
    app = Application.create(clock, cfg, new_db=True)
    out = {"accounts": n}
    try:
        bm = app.bucket_manager
        bl = bm.bucket_list

        # -- seed: the state plane at rung scale.  High seqs walk the
        # spill cadence so entries distribute into deep levels exactly
        # as n real ledgers would have left them.
        chunk = 50_000
        t0 = time.perf_counter()
        seq, done = 10_000_000, 0
        while done < n:
            take = min(chunk, n - done)
            bl.add_batch(
                app, seq, [_ladder_account(i) for i in range(done, done + take)], []
            )
            done += take
            seq += 1
        seed_s = time.perf_counter() - t0
        out["seed_s"] = round(seed_s, 2)
        out["seed_entries_per_s"] = round(n / seed_s, 0)

        # -- traffic: LoadGenerator-shaped payments through the FULL
        # close path (apply, invariants, store flush, add_batch) while
        # the seeded deep levels sit underneath.  Spill merges ride the
        # background worker, so the close wall must not inherit them.
        accounts = [T.get_account(f"ladder-{i}") for i in range(20)]
        root = T.root_key_for(app)
        lm = app.ledger_manager
        from .ledger.accountframe import AccountFrame

        def seq_of(sk):
            return AccountFrame.load_account(
                sk.get_public_key(), app.database
            ).get_seq_num() + 1

        T.close_ledger_on(
            app, lm.last_closed.header.scpValue.closeTime + 5,
            [T.tx_from_ops(app, root, seq_of(root),
                           [T.create_account_op(k, 10**12) for k in accounts])],
        )
        walls = []
        rng = random.Random(11)
        for c in range(traffic_closes):
            txs = []
            for si, sk in enumerate(accounts[: max(1, txs_per_close // 3)]):
                s = seq_of(sk)
                for j in range(3):
                    dst = rng.choice(
                        accounts[:si] + accounts[si + 1:]
                    )
                    txs.append(T.tx_from_ops(
                        app, sk, s + j, [T.payment_op(dst, 1000 + c + j)]
                    ))
            t0 = time.perf_counter()
            T.close_ledger_on(
                app, lm.last_closed.header.scpValue.closeTime + 5, txs
            )
            walls.append(time.perf_counter() - t0)
        out["traffic_closes"] = traffic_closes
        out["txs_per_close"] = len(txs)
        out["close_p50_ms"] = round(statistics.median(walls) * 1e3, 1)
        out["close_max_ms"] = round(max(walls) * 1e3, 1)

        # -- the rung's bucket inventory
        import os as _os

        buckets = []
        for lev in bl.levels:
            for b in (lev.curr, lev.snap):
                if b is not None and not b.is_empty() and b.path:
                    buckets.append((_os.path.getsize(b.path), b))
        buckets.sort(reverse=True, key=lambda t: t[0])
        out["n_buckets"] = len(buckets)
        out["bucket_bytes_total"] = sum(sz for sz, _ in buckets)

        # -- representative spill-merge wall: the two largest buckets
        if len(buckets) >= 2:
            t0 = time.perf_counter()
            Bucket.merge(bm, buckets[0][1], buckets[1][1], [], True)
            out["bucket_merge_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            out["bucket_merge_bytes_in"] = buckets[0][0] + buckets[1][0]

        # -- catchup-from-archive leg: the full-tree re-hash from disk
        # (exactly what archive adoption / selfcheck verify does)
        t0 = time.perf_counter()
        for _, b in buckets:
            h, _cnt = hashplane.hash_file(b.path, app.config)
            assert h == b.get_hash(), "catchup re-hash mismatch"
        rehash_s = time.perf_counter() - t0
        out["catchup_rehash_s"] = round(rehash_s, 2)
        out["catchup_rehash_mb_per_sec"] = round(
            out["bucket_bytes_total"] / rehash_s / 1e6, 1
        ) if rehash_s > 0 else 0.0
        out["rehash_backend"] = hashplane.get_backend(app.config).name

        # -- backend bit-identity + throughput on the rung's own buckets.
        # hashlib and native cover EVERY bucket; the device leg covers
        # buckets up to a byte budget and the coverage is recorded — no
        # silent caps.
        ab = {"bit_identical": True, "device_buckets_covered": 0}
        legs = {"hashlib": [0, 0.0], "native": [0, 0.0], "device": [0, 0.0]}
        backends = {"hashlib": hashplane.backend_by_name("hashlib"),
                    "native": hashplane.backend_by_name("native"),
                    "device": hashplane.backend_by_name("device", device=device)}
        dev_spent = 0
        for size, b in buckets:
            with open(b.path, "rb") as f:
                data = f.read()
            want = None
            for name in ("hashlib", "native", "device"):
                be = backends[name]
                if be is None:
                    continue
                if name == "device":
                    if dev_spent + size > device_byte_budget:
                        continue
                    dev_spent += size
                    ab["device_buckets_covered"] += 1
                t0 = time.perf_counter()
                got = be.hash_frames(data)
                legs[name][0] += size
                legs[name][1] += time.perf_counter() - t0
                if want is None:
                    want = got
                    assert got[0] == b.get_hash()
                elif got != want:
                    ab["bit_identical"] = False
                    ab["mismatch"] = {"bucket": b.get_hash().hex(),
                                      "backend": be.name}
        for name, (nbytes, secs) in legs.items():
            if secs > 0:
                ab[f"{name}_mb_per_sec"] = round(nbytes / secs / 1e6, 1)
        ab["native_available"] = backends["native"] is not None
        ab["device_backend"] = (
            backends["device"].name if backends["device"] else None
        )
        out["backends"] = ab
        return out
    finally:
        app.graceful_stop()
        clock.shutdown()


def ladder(max_rung: int = 1_000_000):
    """The state ladder: every decade rung up to max_rung, written to
    STATE_LADDER_torch.json (acceptance: close p50 at the top rung within
    1.5x of the bottom rung's — spill merges off the close path)."""
    import os

    import torch

    device = _device()
    rungs = [r for r in (10_000, 100_000, 1_000_000) if r <= max_rung]
    results = {}
    for n in rungs:
        print(f"-- rung {n:,} accounts", flush=True)
        r = _rung(n)
        results[str(n)] = r
        print(
            f"   seed {r['seed_entries_per_s']:,.0f} entries/s"
            f" ({r['seed_s']}s); close p50 {r['close_p50_ms']} ms;"
            f" merge {r.get('bucket_merge_ms', 0)} ms;"
            f" catchup re-hash {r['catchup_rehash_mb_per_sec']} MB/s"
            f" [{r['rehash_backend']}];"
            f" backends identical={r['backends']['bit_identical']}",
            flush=True,
        )
        assert r["backends"]["bit_identical"], "backend hash mismatch"
    doc = {
        "cpus": os.cpu_count(),
        "device": (torch.cuda.get_device_name(device)
                   if device.startswith("cuda") else "cpu"),
        "rungs": results,
    }
    lo, hi = str(rungs[0]), str(rungs[-1])
    if lo != hi:
        doc["close_p50_ratio_top_vs_bottom"] = round(
            results[hi]["close_p50_ms"] / results[lo]["close_p50_ms"], 2
        )
    path = os.path.abspath("STATE_LADDER_torch.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    print(f"wrote {path}")
    ratio = doc.get("close_p50_ratio_top_vs_bottom")
    if ratio is not None:
        print(f"close p50 ratio {hi}/{lo} accounts = {ratio}x"
              f" (acceptance: <= 1.5x)")
        return 0 if ratio <= 1.5 else 1
    return 0


def hash_ab(mb: int = 64):
    """Device-vs-host bucket-hash A/B on one framed buffer: exits 1 below
    2x host throughput (a speed verdict; the digests must agree either
    way)."""
    import struct

    from .bucket import hashplane

    device = _device()
    body = bytes(range(256))
    frame = struct.pack(">I", 0x80000000 | len(body)) + body
    reps = (mb << 20) // len(frame)
    data = frame * reps
    host = hashplane.backend_by_name("native") or hashplane.backend_by_name(
        "hashlib"
    )
    dev = hashplane.backend_by_name("device", device=device)

    def leg(be, warm=1, runs=3):
        for _ in range(warm):
            out = be.hash_frames(data)
        t0 = time.perf_counter()
        for _ in range(runs):
            assert be.hash_frames(data) == out
        return len(data) * runs / (time.perf_counter() - t0) / 1e6, out

    host_rate, host_out = leg(host)
    dev_rate, dev_out = leg(dev)
    assert dev_out == host_out, "device hash != host hash"
    ratio = dev_rate / host_rate if host_rate else 0.0
    print(
        f"host[{host.name}] {host_rate:,.1f} MB/s;"
        f" device[{dev.name}] {dev_rate:,.1f} MB/s; ratio {ratio:.2f}x"
        f" (gate: >= 2x)"
    )
    return 0 if ratio >= 2.0 else 1


def _cli(args) -> int:
    _device()  # no card, no run: exit 2 before anything is measured
    cmd = args[0] if args else "bucket"
    if cmd == "bucket":
        bucket(int(args[1]) if len(args) > 1 else 100_000)
    elif cmd == "autoload":
        autoload(
            int(args[1]) if len(args) > 1 else 30_000,
            args[2] if len(args) > 2 else "payments",
        )
    elif cmd == "ladder":
        return ladder(int(args[1]) if len(args) > 1 else 1_000_000)
    elif cmd == "hash_ab":
        return hash_ab(int(args[1]) if len(args) > 1 else 64)
    else:
        sys.exit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
