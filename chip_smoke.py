#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch/CUDA port's paths on one card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero, and no
phase's failure is caught while the run carries on):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — seconds to build the three CUDA kernel libraries (one nvcc
              each, all started together) and the C host stage from the
              sources in this checkout, with each kernel's ptxas report;
3. kernels  — each ported kernel on the card at its path's shapes, held
              against its plain PyTorch version on the same inputs on the
              card with zero mismatches.  ``ms`` is the kernel's own time:
              50 launches captured in a CUDA graph, the graph replayed
              between one pair of CUDA events (``graph_ms``); ``call_ms``
              is one call of the wrapper between an event pair, host work
              included; ``launch_floor_ms`` is an empty kernel timed as
              ``ms`` is.  Shapes:
              - ed25519_verify: 4096 packed lanes of mixed valid/invalid/
                raw classes, both verdict classes present; then the first
                904 lanes (a 5000-tx ledger's tail chunk) and the first 300
                (an SCP flush), each held against the slice of the 4096-
                lane plain verdicts, and the 4096 lanes 8 times over
                (32768); the row names the kernel's threads per signature
                and block size;
              - sha512_h: 4096 device-hash lanes (every single-block
                message length 0-47, host-hashed longer messages, gate-
                rejected inert lanes), into a new tensor and in place; an
                all-flag-0 chunk must come back unchanged;
              - sha256_frames: a 4 MB BucketHasher flush (~40,000 frames)
                and the whole two-block class of the 10^6-record bucket,
                with the padding-boundary lengths among the messages;
4. main path — ``make_backend("gpu")`` in a fresh verify cache (the
              node's composition with its defaults; the default cutover is
              0, so every batch goes to the card):
              (a) a 5000-transaction single-signer ledger (caller "close"),
              then the next ledger through ``verify_batch_async`` (caller
              "pipeline"); (b) a 1000-transaction 3-of-5 multisig txset
              (3000 signatures, 5000 signer keys); (c) 300 SCP envelope
              signatures over 100-300 byte statements (caller "overlay");
              (d) ledger (a)'s valid signatures again: all cache hits, no
              launch.  Verdicts are known by construction and checked
              against the port's ref25519 on a seeded sample and against
              libsodium on every lane when it loads.  The launch counters
              are set to 0 just before and read just after: the kernel must
              have launched, the plain version must not have run, no item
              may have gone to the host and no dispatch may have stalled;
5. main path, device hash — loads (a)-(c) again through a second
              ``make_backend("gpu", device_hash=True)`` in a fresh cache:
              the 32-byte tx hashes are hashed on the card by the SHA-512
              kernel, the SCP statements (multi-block) on the host by
              ``stage_raw`` and merged through the flag row.  Same verdict
              checks; both kernels must have launched and neither plain
              version run; span sums beside the host-hash run's;
6. torsion  — ``torsion_check`` on 512 encodings against
              ``ref25519.is_torsion_free``;
7. bucket hash — the port's ``bucket/hashplane`` on a seeded framed
              buffer of 10^6 records (~108 MB, the 10^6-account rung of
              STATE_LADDER_r22.json): ``hash_frames`` over the whole buffer
              and ``BucketHasher`` frame by frame, each through the device,
              native and hashlib backends — all six hashes equal; the
              SHA-256 kernel launched and its plain version did not run; MB/s
              per backend and the device backend's stage spans;
8. node close — ``node_close``: BASELINE.md's 5000-tx single-signer ledger
              through a standalone validator (``Application`` →
              ``TxSetFrame.check_valid`` → ``LedgerManager.close_ledger``,
              ``SIGNATURE_BACKEND = "gpu"``, 4096-lane chunks): 5001
              accounts created, then three timed closes of 5000 payments
              from distinct accounts and one untimed close, in three legs
              on one set of pre-signed envelopes — the card with host
              hashing, the card with ``DEVICE_HASH``, and the plain versions
              on the CPU (``SIG_DEVICE = "cpu"``, timed closes only).  One
              payment of the second timed round carries a flipped signature
              byte: that round's txset check fails and the payment fails
              ``txBAD_AUTH`` on every leg.  Per leg: close ms (p50, p95),
              the close and flush spans' p50s, the kernels' launches, the
              plain versions' calls (0 on the card legs), eager ref25519
              verifies and stalls (0).  Every header hash equal across the
              legs;
9. node consensus — ``node_consensus``: three validators (threshold 2, all
              running) over the loopback overlay, all on the card, under a
              seeded 300-account, 1000-payment ``LoadGenerator`` load, the
              first node with ``DEVICE_BUCKET_HASH`` (the SHA-256 kernel in
              the bucket list): every node past ledger 5, all agreeing,
              launches > 0, no stall.  Every verify kernel launch of that
              run keeps its input chunk and verdicts, and afterwards the
              plain version verifies all of them again on the card: zero
              mismatches.  Then the same seeded run at 10 accounts and 40
              payments on the card and on the plain versions on the CPU,
              hash for hash (the plain version costs about a second a call
              on the CPU whatever the batch, and the full load makes ~1350
              calls).

Then, on lines of their own: the kernels' JSON line, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.  Keys, messages and bucket records come from a seed; signatures
from libsodium when the port's ``crypto.sodium`` loads it, else from
ref25519 in a process pool.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 20261016
LANES = 4096  # the main path's chunk: SIG_BATCH_MAX
LEDGER_TXS = 5000
MULTISIG_TXS = 1000
SCP_ENVELOPES = 300
TORSION_ENCS = 512
REF_SAMPLE = 256
WIDE_FACTOR = 8
GRAPH_LAUNCHES = 50  # kernel launches captured in one CUDA graph to time a kernel
# the verify kernel's ragged chunks: a 5000-tx ledger's tail (5000 - 4096)
# and a 300-envelope SCP flush
TAIL_LANES = (904, 300)
# bound of the verify kernel (csrc/ed25519_verify.cu header note): field
# squarings and multiplications per lane of the JAX kernel's algorithm (64
# windows, the table of k·(-A), decompress, compress) — the same work
# whatever the kernel skips (it no longer compresses) — and 32-bit integer multiply-adds (low + high half
# each) per 255-bit operation on 8 words: 8x8 word products for a
# multiplication, 36 for a squaring, plus 8 for the x38 fold of the reduction
FIELD_SQRS_PER_VERIFY = 64 * 16 + 255 + 254
FIELD_MULS_PER_VERIFY = 64 * 28 + 142 + 18 + 13
IMAD_PER_FIELD_SQR = 2 * 36 + 2 * 8
IMAD_PER_FIELD_MUL = 2 * 64 + 2 * 8
# bound of the SHA-512 mod L kernel (csrc/sha512_h.cu header note), in
# 32-bit integer instructions per hashed lane: 80 rounds x 28, 64 schedule
# words x 20, feed-forward 16, block assembly 210, mod L 510; bytes moved
# per hashed lane (rows 0:64 and 96:146 read, h written) and per
# passthrough lane (flag and host h read, h written)
SHA512_OPS_PER_LANE = 80 * 28 + 64 * 20 + 16 + 210 + 510
SHA512_BYTES_HASHED = 114 + 32
SHA512_BYTES_PASS = 33 + 32
# bound of the SHA-256 kernel (csrc/sha256_frames.cu header note): 32-bit
# integer instructions per compressed block (64 rounds x 14, 48 schedule
# words x 10, feed-forward 8, 64 bytes merged) and per lane (32 digest
# bytes); bytes: a lane's own blocks, its count and its digest
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 64
SHA256_OPS_PER_LANE = 32
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper);
# 3.35 TB/s HBM3 (data sheet) — both at the full 700 W power limit
H100_IMAD_PER_S = 132 * 64 * 1.98e9
H100_BYTES_PER_S = 3.35e12
# the bucket-hash phase: 10^6 records, as STATE_LADDER_r22.json's
# 10^6-account rung (100,008,100 bucket bytes, ~100 bytes a record)
BUCKET_RECORDS = 1_000_000
# Frame sizes (4-byte header + XDR) of live BucketEntry records as the JAX
# package's codec writes them (stellar_tpu/xdr/entries.py, ledger.py): an
# AccountEntry with no signers and no home domain 100 bytes (the ladder's
# account, profile_system.py::_ladder_account), each signer +40; a
# TrustLineEntry 124 (alphanum4 asset) or 132 (alphanum12); an OfferEntry
# 136 (native/alphanum4), 184 (alphanum4/alphanum12), 192 (alphanum12
# both).  Weights: mostly plain accounts, as the ladder's state.
BUCKET_FRAME_MIX = (
    (100, 0.86), (140, 0.02), (180, 0.01), (260, 0.01),
    (124, 0.03), (132, 0.02), (136, 0.02), (184, 0.02), (192, 0.01),
)
SPILL_FRAMES = 8  # 5004-byte frames: 79 SHA blocks, past DEVICE_MAX_BLOCKS
SPILL_BODY = 5000
# the padding-boundary message lengths of the SHA-256 kernel check
SHA256_BOUNDARY = (0, 55, 56, 63, 64, 65, 119, 120)
# node_close: BASELINE.md's 5000-tx single-signer ledger (bench.py's shape):
# 5001 accounts, 100 creates a tx and 2000 a ledger, then timed rounds of
# 5000 payments and one untimed round; the genesis base fee
NODE_TXS = LEDGER_TXS
NODE_ACCOUNTS = NODE_TXS + 1
NODE_CREATE_PER_TX = 100
NODE_CREATE_PER_LEDGER = 2000
NODE_ROUNDS = 3
NODE_BASE_FEE = 100
# the payment of a timed round whose signature carries a flipped byte
NODE_BAD_ROUND, NODE_BAD_INDEX = 1, 2500
PLAIN_DISPATCH_BUDGET_S = 900.0
# node_consensus: three validators under a seeded LoadGenerator load; the
# card-and-plain pair at a smaller load of the same seeded run
CONSENSUS_ACCOUNTS, CONSENSUS_TXS, CONSENSUS_RATE = 300, 1000, 100
PAIR_ACCOUNTS, PAIR_TXS, PAIR_RATE = 10, 40, 10
CONSENSUS_LEDGERS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- fixtures: keys, signatures, the reference verdicts -----------------------


def _key(seed: bytes):
    """(secret scalar a, prefix, public key) of an RFC 8032 seed."""
    from stellar_tpu_torch.ops import ref25519 as ref

    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    return a, h[32:], ref.compress(ref.scalar_mult(a, ref.base_point()))


def _sign_job(job):
    """(seed, [msgs]) -> (pk, [sigs]) with the pure-Python reference."""
    from stellar_tpu_torch.ops import ref25519 as ref

    seed, msgs = job
    a, prefix, pk = _key(seed)
    B = ref.base_point()
    sigs = []
    for msg in msgs:
        r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % ref.L
        R = ref.compress(ref.scalar_mult(r, B))
        k = int.from_bytes(hashlib.sha512(R + pk + msg).digest(), "little") % ref.L
        sigs.append(R + ((r + k * a) % ref.L).to_bytes(32, "little"))
    return pk, sigs


def _ref_verify_job(item):
    from stellar_tpu_torch.ops import ref25519 as ref

    pk, msg, sig = item
    return ref.verify(pk, msg, sig)


def _ref_torsion_job(enc):
    from stellar_tpu_torch.ops import ref25519 as ref

    if len(enc) != 32 or not ref.fe_is_canonical(enc):
        return False
    pt = ref.decompress(enc)
    return pt is not None and ref.is_torsion_free(pt)


class Fixtures:
    """Seeded keys and signatures; libsodium when it loads, else a pool."""

    def __init__(self, pool):
        from stellar_tpu_torch.crypto import sodium

        self.sodium = sodium.available()
        self.pool = pool

    def sign(self, jobs):
        """[(seed, [msgs])] -> [(pk, [sigs])] in order."""
        if self.sodium:
            from stellar_tpu_torch.crypto import sodium

            out = []
            for seed, msgs in jobs:
                pk, sk = sodium.sign_seed_keypair(seed)
                out.append((pk, [sodium.sign_detached(m, sk) for m in msgs]))
            return out
        return list(self.pool.map(_sign_job, jobs, chunksize=16))

    def ref_verify(self, items):
        return list(self.pool.map(_ref_verify_job, items, chunksize=8))

    def ref_torsion(self, encs):
        return list(self.pool.map(_ref_torsion_job, encs, chunksize=8))


def _seed(tag: str, i: int) -> bytes:
    return hashlib.sha256(b"chip_smoke %s %d %d" % (tag.encode(), SEED, i)).digest()


def corrupt(rng, msg, sig):
    """A seeded corruption that no valid signature survives: a flipped bit
    in R, in s's low byte (s stays < L), or in the message."""
    kind = rng.randrange(3)
    sig = bytearray(sig)
    if kind == 0:
        sig[rng.randrange(32)] ^= 1 << rng.randrange(8)
    elif kind == 1:
        sig[32] ^= 1 << rng.randrange(8)
    else:
        msg = bytes([msg[0] ^ 1]) + msg[1:]
    return msg, bytes(sig)


def make_load(fx, rng, tag, n_keys, per_key_msgs, bad_rate=0.01):
    """Signed triples plus the expected verdicts (by construction)."""
    jobs = [(_seed(tag, k), per_key_msgs(k)) for k in range(n_keys)]
    signed = fx.sign(jobs)
    items, want = [], []
    for (pk, sigs), (_, msgs) in zip(signed, jobs):
        for msg, sig in zip(msgs, sigs):
            ok = rng.random() >= bad_rate
            if not ok:
                msg, sig = corrupt(rng, msg, sig)
            items.append((pk, msg, sig))
            want.append(ok)
    return items, want


# -- phase 3: the kernel against its plain version ---------------------------


def kernel_lanes(rng, ledger_items, n=LANES):
    """(128, n) packed uint8 lanes mixing: valid signatures, corrupted
    R, corrupted s (kept < L), undecompressable A, non-canonical A (y >= p),
    s >= L, small-order A/R encodings, and random bytes."""
    import numpy as np

    from stellar_tpu_torch.ops import ref25519 as ref

    def h_of(R, A, M):
        h = int.from_bytes(hashlib.sha512(R + A + M).digest(), "little") % ref.L
        return h.to_bytes(32, "little")

    bad_a = next(
        c.to_bytes(32, "little")
        for c in range(2, 1000)
        if ref.decompress(c.to_bytes(32, "little")) is None
    )
    small = ref.small_order_blacklist()
    B = ref.base_point()
    packed = np.zeros((128, n), dtype=np.uint8)
    for i in range(n):
        pk, msg, sig = ledger_items[i]
        A, R, S = pk, sig[:32], sig[32:]
        cls = i % 8
        if cls == 1:
            R = bytes([R[0] ^ (1 << (i % 8))]) + R[1:]
        elif cls == 2:
            S = bytes([S[0] ^ (1 << (i % 8))]) + S[1:]
        elif cls == 3:
            A = bad_a
        elif cls == 4:
            # y = p + k (k < 19) with either sign; every 16th such lane is
            # A := the identity's alias p + 1 with R := enc(s·B), which the
            # kernel must accept
            k = rng.randrange(19)
            A = ((ref.P + k) | (rng.randrange(2) << 255)).to_bytes(32, "little")
            if i % 128 == 4:
                A = (ref.P + 1).to_bytes(32, "little")
                R = ref.compress(ref.scalar_mult(int.from_bytes(S, "little"), B))
        elif cls == 5:
            S = (int.from_bytes(S, "little") + ref.L).to_bytes(32, "little")
        elif cls == 6:
            if i % 16 == 6:
                A = rng.choice(small)
            else:
                R = rng.choice(small)
        elif cls == 7:
            A, R, S = (bytes(rng.getrandbits(8) for _ in range(32)) for _ in range(3))
        H = h_of(R, A, msg)
        if cls == 4 and i % 128 == 4:
            H = bytes(32)
        for row, col in ((0, A), (32, R), (64, S), (96, H)):
            packed[row : row + 32, i] = np.frombuffer(col, dtype=np.uint8)
    return packed


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events: one
    call between the events, so a wrapper's host work counts."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches=GRAPH_LAUNCHES, reps=5):
    """Milliseconds of one launch of ``fn``'s kernel: ``launches`` calls of
    ``fn`` captured into one CUDA graph (the wrapper launches on the current
    stream, which is the capture stream), the graph replayed between one
    pair of CUDA events and the time divided by ``launches``; the median of
    ``reps`` replays after a warm-up.  The wrapper's host work runs at
    capture only, so this is the kernels' time back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def launch_floor_ms():
    """``graph_ms`` of an empty kernel: the least time a launch takes."""
    import torch

    from stellar_tpu_torch.ops import sha512_cuda as sc

    return graph_ms(lambda: sc.launch_noop(torch.device("cuda")))


def phase_kernels(rng, ledger_items):
    import torch

    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    packed = torch.from_numpy(kernel_lanes(rng, ledger_items)).cuda()
    got = ec.verify_packed(packed)
    torch.cuda.synchronize()
    plain = ed._verify_packed(packed)
    torch.cuda.synchronize()
    mismatches = int((got != plain).sum())
    accepts = int(got.sum())
    max_abs_err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
    assert mismatches == 0, f"kernel disagrees with the plain version on {mismatches} lanes"
    assert 0 < accepts < LANES, f"verdict classes missing: {accepts} accepts"
    ec.verify_packed(packed)  # warm-up
    ms = graph_ms(lambda: ec.verify_packed(packed))
    call_ms = cuda_ms(lambda: ec.verify_packed(packed), 7)
    plain_ms = cuda_ms(lambda: ed._verify_packed(packed), 3)
    tails = {}
    for n in TAIL_LANES:
        part = packed[:, :n].contiguous()
        bad = int((ec.verify_packed(part) != plain[:n]).sum())
        assert bad == 0, f"kernel disagrees with the plain version on {bad} of the first {n} lanes"
        tails[n] = {"mismatches": bad, "ms": graph_ms(lambda: ec.verify_packed(part)),
                    "call_ms": cuda_ms(lambda: ec.verify_packed(part), 7)}
    # the same lanes 8 times over: 4096 lanes fill one warp per scheduler at
    # most; the wide shape shows how the time grows past that
    wide = packed.repeat(1, WIDE_FACTOR).contiguous()
    wide_bad = int((ec.verify_packed(wide) != plain.repeat(WIDE_FACTOR)).sum())
    assert wide_bad == 0, f"kernel disagrees with the plain version on {wide_bad} wide lanes"
    wide_ms = graph_ms(lambda: ec.verify_packed(wide), reps=3)
    wide_call_ms = cuda_ms(lambda: ec.verify_packed(wide), 5)
    threads_per_lane, block_threads = ec.geometry()
    imads = FIELD_MULS_PER_VERIFY * IMAD_PER_FIELD_MUL + FIELD_SQRS_PER_VERIFY * IMAD_PER_FIELD_SQR
    ops_s = LANES * imads / H100_IMAD_PER_S
    bytes_s = (packed.numel() + LANES) / H100_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    row = {
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "stellar_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_tpu/ops/ed25519_pallas.py:171",
        "lanes": LANES,
        "mismatches": mismatches,
        "accepts": accepts,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
        "threads_per_lane": threads_per_lane,
        "block_threads": block_threads,
    }
    emit({"phase": "kernels", **row, "tails": tails, "wide_lanes": wide.shape[1],
          "wide_mismatches": wide_bad, "wide_ms": wide_ms, "wide_call_ms": wide_call_ms})
    return row


def sha512_lanes(rng, ledger_items, n=LANES):
    """(160, n) device-hash lanes staged by the port's ``stage_raw``:
    message lengths 0..59 in turn — 0..47 upload raw with flag 1, 48..59 are
    hashed on the host with flag 0 — and every 16th lane gate-rejected
    (s := L: an inert zero lane).  Returns the lanes, the items and the
    gate verdicts."""
    import numpy as np

    from stellar_tpu_torch import native
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import sha512 as tsha

    items = []
    for i in range(n):
        pk, _, sig = ledger_items[i]
        if i % 16 == 15:
            sig = sig[:32] + tsha.L.to_bytes(32, "little")
        items.append((pk, rng.randbytes(i % 60), sig))
    packed = np.zeros((tsha.DH_ROWS, n), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    native.load_sighash().stage_raw(items, 0, n, packed, ok, ed._BLACKLIST, 0)
    return packed, items, ok


def phase_kernel_sha512(rng, ledger_items):
    import torch

    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc

    packed, items, ok = sha512_lanes(rng, ledger_items)
    p = torch.from_numpy(packed).cuda()
    got = sc.h_rows(p)
    torch.cuda.synchronize()
    plain = tsha.h_rows_from_packed(p).to(torch.uint8)
    mismatches = int((got != plain).any(dim=0).sum())
    max_abs_err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
    assert mismatches == 0, f"sha512_h disagrees with the plain version on {mismatches} lanes"
    # in place, as the verify plane calls it: h in rows 96:128, nothing else moves
    q = p.clone()
    sc.hash_in_place(q)
    torch.cuda.synchronize()
    assert torch.equal(q[96:128], plain), "in-place h differs"
    assert torch.equal(q[:96], p[:96]) and torch.equal(q[128:], p[128:]), "in place moved other rows"
    # a chunk with no flag-1 lane: rows 96:128 (the host h) come back as they were
    flag0 = p.clone()
    flag0[tsha.ROW_FLAG] = 0
    before = flag0.clone()
    sc.hash_in_place(flag0)
    torch.cuda.synchronize()
    assert torch.equal(flag0, before), "an all-flag-0 chunk changed"
    host = got.t().contiguous().cpu().numpy()
    for j, (pk, msg, sig) in enumerate(items):
        if ok[j]:
            want = tsha.reduce_digest(hashlib.sha512(sig[:32] + pk + msg).digest())
            assert host[j].tobytes() == want, f"lane {j}: h is not SHA-512(R||A||M) mod L"
    flags = packed[tsha.ROW_FLAG]
    hashed = int((flags != 0).sum())
    lanes = {
        "flag1": hashed,
        "flag0_host_h": int(((flags == 0) & (ok == 1)).sum()),
        "rejected": int((ok == 0).sum()),
    }
    assert min(lanes.values()) > 0, lanes
    sc.h_rows(p)  # warm-up
    ms = graph_ms(lambda: sc.h_rows(p))
    call_ms = cuda_ms(lambda: sc.h_rows(p), 21)
    # in place, as the verify plane calls it (each call hashes the rows the
    # last one wrote: the same work)
    in_place_ms = graph_ms(lambda: sc.hash_in_place(q))
    in_place_call_ms = cuda_ms(lambda: sc.hash_in_place(q), 21)
    plain_ms = cuda_ms(lambda: tsha.h_rows_from_packed(p), 3)
    ops_s = hashed * SHA512_OPS_PER_LANE / H100_IMAD_PER_S
    bytes_s = (hashed * SHA512_BYTES_HASHED + (LANES - hashed) * SHA512_BYTES_PASS) / H100_BYTES_PER_S
    row = {
        "name": "sha512_h",
        "route": "cuda",
        "source": "stellar_tpu_torch/csrc/sha512_h.cu",
        "replaces": "stellar_tpu/ops/sha512.py:533",
        "lanes": LANES,
        "lane_classes": lanes,
        "mismatches": mismatches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "call_ms": call_ms,
        "in_place_ms": in_place_ms,
        "in_place_call_ms": in_place_call_ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(ops_s, bytes_s),
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernels", **row})
    return row


def sha256_shapes(frames, frame_len):
    """The bucket path's two kernel shapes, as (name, messages, max_blocks):
    the frames of the first 4 MB BucketHasher flush that fit in 4 blocks,
    and the two-block class of the whole buffer — each with the padding-
    boundary messages that fit."""
    import numpy as np

    from stellar_tpu_torch.bucket import hashplane as hp
    from stellar_tpu_torch.ops import sha256 as t256

    rng = random.Random(SEED + 2)
    boundary = [rng.randbytes(n) for n in SHA256_BOUNDARY]
    flush = int(np.searchsorted(np.cumsum(frame_len), hp._FLUSH_BYTES)) + 1
    nblocks = (frame_len + 8) // 64 + 1
    fit4 = [frames[i] for i in np.flatnonzero(nblocks[:flush] <= 4)]
    two = [frames[i] for i in np.flatnonzero(nblocks == 2)]
    return [
        ("flush_4MB", fit4 + boundary, 4),
        ("class_2_blocks", two + [m for m in boundary if t256.blocks_for(len(m)) <= 2], 2),
    ]


def pack_frames_loop(items, max_blocks):
    """The JAX package's per-item packer (``ops/sha256.py::pack_frames``),
    copied to time it beside the port's vectorised one on the same frames."""
    import numpy as np

    counts = np.asarray([(len(it) + 8) // 64 + 1 for it in items], np.int32)
    packed = np.zeros((max_blocks * 64, max(len(items), 1)), dtype=np.uint8)
    for i, it in enumerate(items):
        ln = len(it)
        end = int(counts[i]) * 64
        if ln:
            packed[:ln, i] = np.frombuffer(it, dtype=np.uint8)
        packed[ln, i] = 0x80
        packed[end - 8 : end, i] = np.frombuffer(struct.pack(">Q", ln * 8), dtype=np.uint8)
    return packed, counts


def phase_kernel_sha256(frames, frame_len):
    import torch

    from stellar_tpu_torch.ops import sha256 as t256
    from stellar_tpu_torch.ops import sha256_cuda as c256

    shapes = []
    for name, msgs, max_blocks in sha256_shapes(frames, frame_len):
        t0 = time.perf_counter()
        packed, counts = t256.pack_frames(msgs, max_blocks)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loop_packed, loop_counts = pack_frames_loop(msgs, max_blocks)
        pack_loop_s = time.perf_counter() - t0
        assert (loop_packed == packed).all() and (loop_counts == counts).all(), name
        del loop_packed
        p, nb = torch.from_numpy(packed).cuda(), torch.from_numpy(counts).cuda()
        got = c256.digest_rows(p, nb)
        torch.cuda.synchronize()
        plain = t256.sha256_rows_from_packed(p, nb).to(torch.uint8)
        mismatches = int((got != plain).any(dim=0).sum())
        max_abs_err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
        assert mismatches == 0, f"sha256_frames ({name}) disagrees on {mismatches} lanes"
        host = got.t().contiguous().cpu().numpy()
        n = len(msgs)
        check = list(range(n - len(SHA256_BOUNDARY), n)) + random.Random(SEED).sample(range(n), 1000)
        for j in check:
            assert host[j].tobytes() == hashlib.sha256(msgs[j]).digest(), f"{name} lane {j}"
        c256.digest_rows(p, nb)  # warm-up
        ms = graph_ms(lambda: c256.digest_rows(p, nb))
        call_ms = cuda_ms(lambda: c256.digest_rows(p, nb), 11)
        plain_ms = cuda_ms(lambda: t256.sha256_rows_from_packed(p, nb), 2)
        blocks = int(counts.sum())
        ops_s = (blocks * SHA256_OPS_PER_BLOCK + n * SHA256_OPS_PER_LANE) / H100_IMAD_PER_S
        bytes_s = (64 * blocks + 36 * n) / H100_BYTES_PER_S
        shape = {
            "shape": name, "lanes": n, "max_blocks": max_blocks, "blocks": blocks,
            "pack_s": pack_s, "pack_loop_s": pack_loop_s, "mismatches": mismatches, "max_abs_err": max_abs_err,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        }
        emit({"phase": "kernels", "name": "sha256_frames", **shape})
        shapes.append(shape)
    main = shapes[-1]  # the whole two-block class of the 10^6-record bucket
    return {
        "name": "sha256_frames",
        "route": "cuda",
        "source": "stellar_tpu_torch/csrc/sha256_frames.cu",
        "replaces": "stellar_tpu/ops/sha256.py:183",
        **{k: main[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }


# -- phase 4: the main path ---------------------------------------------------


class SpanSums:
    """A tracer (``span``/``begin``/``end``) that keeps the total seconds of
    each span name — the host-side breakdown of a load: staging, launch
    (enqueue only), and drain (the wait for the card)."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._sums = {}

    def begin(self, name, **attrs):
        return (name, time.perf_counter())

    def end(self, span, **attrs):
        if span is not None:
            name, t0 = span
            dt = time.perf_counter() - t0
            with self._lock:
                self._sums[name] = self._sums.get(name, 0.0) + dt

    def span(self, name, **attrs):
        import contextlib

        @contextlib.contextmanager
        def scope():
            sp = self.begin(name)
            try:
                yield sp
            finally:
                self.end(sp)

        return scope()

    def take_ms(self):
        with self._lock:
            out = {k: v * 1e3 for k, v in sorted(self._sums.items())}
            self._sums.clear()
        return out


def check_load(fx, rng, name, items, want, got):
    assert got == want, (
        f"{name}: {sum(g != w for g, w in zip(got, want))} verdicts differ "
        "from the expected ones"
    )
    sample = rng.sample(range(len(items)), min(REF_SAMPLE, len(items)))
    ref_got = fx.ref_verify([items[j] for j in sample])
    assert ref_got == [want[j] for j in sample], f"{name}: ref25519 disagrees"
    if fx.sodium:
        from stellar_tpu_torch.crypto import sodium

        sod = [sodium.verify_detached(s, m, p) for p, m, s in items]
        assert sod == want, f"{name}: libsodium disagrees"


def phase_main(fx, rng, loads, device_hash=False):
    """The loads through a fresh ``make_backend("gpu")``; returns the
    backend, the main path's launch counts and each load's (ms, spans)."""
    from stellar_tpu_torch.crypto import make_backend
    from stellar_tpu_torch.crypto.sigcache import VerifySigCache
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc

    tracer = SpanSums()
    backend = make_backend("gpu", cache=VerifySigCache(), tracer=tracer, device_hash=device_hash)
    phase = "main_path_device_hash" if device_hash else "main_path"
    results = []
    ec.launches = sc.launches = 0
    ed.plain_calls = tsha.plain_calls = 0
    for name, caller, items, want, run in loads(backend):
        before = (ec.launches, sc.launches)
        t0 = time.perf_counter()
        got = run(backend, items, caller)
        sec = time.perf_counter() - t0
        launched = {"ed25519_verify": ec.launches - before[0], "sha512_h": sc.launches - before[1]}
        results.append((name, caller, items, want, got, sec, tracer.take_ms(), launched))
    launches = {"ed25519_verify": ec.launches, "sha512_h": sc.launches}
    plain_calls = {"ed25519": ed.plain_calls, "sha512": tsha.plain_calls}
    stats = backend.stats()
    per_load = {}
    for name, caller, items, want, got, sec, spans, launched in results:
        check_load(fx, rng, name, items, want, got)
        emit({
            "phase": phase, "load": name, "caller": caller,
            "signatures": len(items), "invalid": want.count(False),
            "ms": sec * 1e3, "verifies_per_s": len(items) / sec,
            "launches": launched, "span_ms": spans,
        })
        per_load[name] = {"ms": sec * 1e3, "span_ms": spans}
        assert launched["ed25519_verify"] > 0, f"{name}: the verify kernel never launched"
        if device_hash:
            # tx hashes (32 bytes) hash on the card; SCP statements (100-300
            # bytes) are multi-block, hashed by stage_raw: a flag-0-only load
            single_block = all(len(m) <= tsha.MAX_DEVICE_MSG for _, m, _ in items)
            assert (launched["sha512_h"] > 0) == single_block, (name, launched)
    assert launches["ed25519_verify"] > 0, "the main path never launched the CUDA kernel"
    if device_hash:
        assert launches["sha512_h"] > 0, "the device-hash path never launched the SHA-512 kernel"
    else:
        assert launches["sha512_h"] == 0, "the host-hash path launched the SHA-512 kernel"
    assert plain_calls == {"ed25519": 0, "sha512": 0}, f"plain versions ran on the main path: {plain_calls}"
    assert stats["device_hash"] is device_hash, stats["device_hash"]
    for key in ("cpu_cutover_items", "stall_rejected_items", "host_assist_items"):
        assert stats[key] == 0, f"{key} = {stats[key]}: items left the device"
    assert stats["wedge_latch_flips"] == {}, f"device stalls: {stats['wedge_latch_flips']}"
    emit({
        "phase": phase, "launches": launches, "plain_calls": plain_calls,
        "libsodium_checked": fx.sodium, "stats": stats,
    })
    return backend, launches, per_load


def phase_torsion(fx, rng, backend, pks):
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import ref25519 as ref

    # a point of order 8: [L]·P of a point with a full torsion component
    t8 = None
    y = 2
    while t8 is None:
        pt = ref.decompress(y.to_bytes(32, "little"))
        y += 1
        if pt is not None:
            t = ref.scalar_mult(ref.L, pt)
            if not ref.point_equal(ref.scalar_mult(4, t), ref.IDENT):
                t8 = t
    encs = []
    for i in range(TORSION_ENCS):
        cls = i % 4
        pk = pks[i]
        if cls == 1:  # a prime-order point plus a small-order point
            tk = ref.scalar_mult(1 + i % 7, t8)
            encs.append(ref.compress(ref.point_add(ref.decompress(pk), tk)))
        elif cls == 2:  # undecodable bytes
            encs.append(bytes(rng.getrandbits(8) for _ in range(32)))
        elif cls == 3 and i % 8 == 3:  # small-order encodings themselves
            encs.append(rng.choice(ref.small_order_blacklist()))
        else:
            encs.append(pk)
    want = fx.ref_torsion(encs)
    ec.launches = 0
    ed.plain_calls = 0
    t0 = time.perf_counter()
    got = backend.torsion_check(encs)
    sec = time.perf_counter() - t0
    launches, plain_calls = ec.launches, ed.plain_calls
    assert got == want, f"torsion: {sum(g != w for g, w in zip(got, want))} verdicts differ"
    assert launches > 0 and plain_calls == 0, (launches, plain_calls)
    emit({
        "phase": "torsion", "encodings": len(encs), "torsion_free": sum(want),
        "launches": launches, "ms": sec * 1e3,
    })


class _BucketKnob:
    """The config surface ``hashplane.get_backend`` reads."""

    def __init__(self, on):
        self.DEVICE_BUCKET_HASH = on


def bucket_buffer(seed):
    """A framed record buffer of BUCKET_RECORDS frames: seeded body bytes,
    frame sizes drawn from BUCKET_FRAME_MIX in a seeded order, and
    SPILL_FRAMES oversized frames among them.  Returns (buffer, frame
    lengths)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = np.array([size for size, _ in BUCKET_FRAME_MIX], dtype=np.int64)
    weights = np.array([w for _, w in BUCKET_FRAME_MIX])
    frame_len = rng.choice(sizes, size=BUCKET_RECORDS, p=weights / weights.sum())
    frame_len[rng.choice(BUCKET_RECORDS, SPILL_FRAMES, replace=False)] = SPILL_BODY + 4
    offsets = np.concatenate([[0], np.cumsum(frame_len)])
    buf = rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)
    hdr = ((frame_len - 4) | 0x80000000).astype(">u4").view(np.uint8).reshape(-1, 4)
    buf[offsets[:-1, None] + np.arange(4)] = hdr
    return buf.tobytes(), frame_len


def phase_bucket(buf, frames):
    """``hash_frames`` and ``BucketHasher`` through the device, native and
    hashlib backends, resolved as a node resolves them (the config knob,
    the no-native environment variable).  Returns the SHA-256 kernel's
    launches over the whole bucket."""
    from stellar_tpu_torch.bucket import hashplane as hp
    from stellar_tpu_torch.ops import sha256 as t256
    from stellar_tpu_torch.ops import sha256_cuda as c256

    mb = len(buf) / 1e6
    hashes = {}
    device_launches = None
    for name, knob, no_native in (("device", True, False), ("native", False, False),
                                  ("hashlib", False, True)):
        if no_native:
            os.environ["STELLAR_TPU_NO_NATIVE_HASH"] = "1"
        else:
            os.environ.pop("STELLAR_TPU_NO_NATIVE_HASH", None)
        hp.reset_backend_cache()
        cfg = _BucketKnob(knob)
        backend = hp.get_backend(cfg)
        assert backend.name == ("device-cuda" if knob else name), backend.name
        spans = SpanSums()
        if knob:
            backend.tracer = spans
        c256.launches = 0
        t256.plain_calls = 0
        t0 = time.perf_counter()
        whole = hp.hash_frames(buf, cfg)
        whole_s = time.perf_counter() - t0
        whole_launches, whole_spans = c256.launches, spans.take_ms()
        t0 = time.perf_counter()
        hasher = hp.BucketHasher(cfg)
        for fr in frames:
            hasher.add(fr)
        streamed = (hasher.finish(), hasher.count)
        streamed_s = time.perf_counter() - t0
        launches, plain_calls = c256.launches, t256.plain_calls
        line = {
            "phase": "bucket_hash", "backend": backend.name, "records": whole[1],
            "mb": mb, "hash": whole[0].hex(),
            "hash_frames_s": whole_s, "hash_frames_mb_per_s": mb / whole_s,
            "bucket_hasher_s": streamed_s, "bucket_hasher_mb_per_s": mb / streamed_s,
            "launches": {"hash_frames": whole_launches, "bucket_hasher": launches - whole_launches},
            "plain_calls": plain_calls,
        }
        if knob:
            assert whole_launches > 0 and launches > whole_launches, "the SHA-256 kernel never launched"
            assert plain_calls == 0, f"the plain SHA-256 ran {plain_calls} times"
            line["span_ms"] = {"hash_frames": whole_spans, "bucket_hasher": spans.take_ms()}
            device_launches = whole_launches
        emit(line)
        hashes[name] = (whole, streamed)
    os.environ.pop("STELLAR_TPU_NO_NATIVE_HASH", None)
    hp.reset_backend_cache()
    results = {r for pair in hashes.values() for r in pair}
    assert len(results) == 1 and next(iter(results))[1] == BUCKET_RECORDS, hashes
    return device_launches


# -- phases 8-9: the validator node -----------------------------------------


def _account_seed(n: int) -> bytes:
    """The seed of the node's test account n (``tx.testutils.get_account``)."""
    return hashlib.sha256(b"stellar_tpu test seed %d" % n).digest()


def _p(times, q):
    """The q-quantile of a few samples: the sample at rank ceil(q·n)."""
    xs = sorted(times)
    return xs[max(0, min(len(xs) - 1, -(-int(q * 100) * len(xs) // 100) - 1))]


def node_config(tmp, tag, device, **knobs):
    """A standalone validator's config: the gpu backend on ``device``, the
    main path's 4096-lane chunks, state under ``tmp``."""
    from stellar_tpu_torch.tx import testutils as T

    cfg = T.get_test_config(0, backend="gpu")
    cfg.SIG_DEVICE = device
    cfg.SIG_BATCH_MAX = LANES
    cfg.BUCKET_DIR_PATH = os.path.join(tmp, tag, "buckets")
    cfg.TMP_DIR_PATH = os.path.join(tmp, tag, "tmp")
    for k, v in knobs.items():
        setattr(cfg, k, v)
    return cfg


class NodeCloseLoad:
    """BASELINE.md's close shape, signed once for every leg: NODE_ACCOUNTS
    accounts created by root-signed txs (100 creates a tx, 2000 a ledger,
    the first ledger carrying a MAX_TX_SET_SIZE upgrade), then rounds of
    NODE_TXS single-signer payments from distinct accounts.  A signature
    depends only on the network id, the source, the sequence number and
    the operations, so the envelopes serve every leg; each leg wraps them in
    fresh frames."""

    def __init__(self, fx, network_id, fee):
        from stellar_tpu_torch.crypto.keys import SecretKey
        from stellar_tpu_torch.tx.frame import TransactionFrame
        from stellar_tpu_torch.xdr import txs as X
        from stellar_tpu_torch.xdr.xtypes import PublicKey

        self.network_id = network_id
        seeds = [_account_seed(i + 1) for i in range(NODE_ACCOUNTS)]
        pks = [pk for pk, _ in fx.sign([(sd, []) for sd in seeds])]
        ids = [PublicKey.from_ed25519(pk) for pk in pks]

        def envelope(src, seq, ops):
            tx = X.Transaction(sourceAccount=src, fee=fee * len(ops), seqNum=seq,
                               timeBounds=None, memo=X.Memo.none(), operations=ops, ext=0)
            env = X.TransactionEnvelope(tx, [])
            return env, TransactionFrame(network_id, env).get_contents_hash()

        def sign(env, pk, sig):
            env.signatures.append(X.DecoratedSignature(pk[-4:], sig))

        root = SecretKey.from_seed(network_id)
        root_seq = 0
        self.create_ledgers = []
        created_at = [0] * NODE_ACCOUNTS
        for lo in range(0, NODE_ACCOUNTS, NODE_CREATE_PER_LEDGER):
            ledger_envs = []
            for i in range(lo, min(lo + NODE_CREATE_PER_LEDGER, NODE_ACCOUNTS), NODE_CREATE_PER_TX):
                root_seq += 1
                ops = [X.Operation(None, X.OperationBody(
                    X.OperationType.CREATE_ACCOUNT, X.CreateAccountOp(ids[j], 10**10)))
                    for j in range(i, min(i + NODE_CREATE_PER_TX, NODE_ACCOUNTS))]
                env, h = envelope(root.get_public_key(), root_seq, ops)
                sign(env, root.public_raw, root.sign(h))
                ledger_envs.append(env)
            for j in range(lo, min(lo + NODE_CREATE_PER_LEDGER, NODE_ACCOUNTS)):
                created_at[j] = 2 + len(self.create_ledgers)
            self.create_ledgers.append(ledger_envs)
        self.rounds = [[None] * NODE_TXS for _ in range(NODE_ROUNDS + 1)]
        jobs = []
        for i in range(NODE_TXS):
            hashes = []
            for r in range(NODE_ROUNDS + 1):
                op = X.Operation(None, X.OperationBody(
                    X.OperationType.PAYMENT, X.PaymentOp(ids[i + 1], X.Asset.native(), 1000)))
                env, h = envelope(ids[i], (created_at[i] << 32) + 1 + r, [op])
                self.rounds[r][i] = env
                hashes.append(h)
            jobs.append((seeds[i], hashes))
        for i, (pk, sigs) in enumerate(fx.sign(jobs)):
            for r, sig in enumerate(sigs):
                sign(self.rounds[r][i], pk, sig)
        ds = self.rounds[NODE_BAD_ROUND][NODE_BAD_INDEX].signatures[0]
        ds.signature = bytes([ds.signature[0] ^ 1]) + ds.signature[1:]

    def frames(self, envs):
        from stellar_tpu_torch.tx.frame import TransactionFrame

        return [TransactionFrame(self.network_id, env) for env in envs]


def _node_counts(reset=False):
    """The kernels' launch counts, their plain versions' call counts, the
    eager ref25519 verifies — set to 0 when ``reset``."""
    from stellar_tpu_torch.crypto import keys
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import sha256 as t256
    from stellar_tpu_torch.ops import sha256_cuda as c256
    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc

    if reset:
        ec.launches = sc.launches = c256.launches = 0
        ed.plain_calls = tsha.plain_calls = t256.plain_calls = 0
        keys.reset_stats()
        keys.PubKeyUtils.clear_verify_sig_cache()
        return None
    return {
        "launches": {"ed25519_verify": ec.launches, "sha512_h": sc.launches,
                     "sha256_frames": c256.launches},
        "plain_calls": {"ed25519": ed.plain_calls, "sha512": tsha.plain_calls,
                        "sha256": t256.plain_calls},
        "eager_ref_verifies": keys.stats()["eager_ref_verifies"],
    }


def _stalls(stats):
    return stats["stall_rejected_items"] + sum(stats["wedge_latch_flips"].values())


def node_close_leg(load, tmp, leg, device, device_hash, untimed_close):
    """One standalone validator: the account ledgers, NODE_ROUNDS timed
    closes (``TxSetFrame.check_valid`` + ``LedgerManager.close_ledger``, on
    the card the next round registered as the close pipeline's prewarm
    candidate, as bench.py times them), and the untimed extra close when
    asked.  The plain leg registers no candidate: its prewarm would still
    run when the next round's check_valid verifies the same signatures
    again, twice the CPU work for the same hashes."""
    from stellar_tpu_torch.herder.ledgerclose import LedgerCloseData
    from stellar_tpu_torch.herder.txset import TxSetFrame
    from stellar_tpu_torch.main.application import Application
    from stellar_tpu_torch.util.clock import REAL_TIME, VirtualClock
    from stellar_tpu_torch.xdr.base import xdr_to_opaque
    from stellar_tpu_torch.xdr.ledger import LedgerUpgrade, LedgerUpgradeType, StellarValue

    cfg = node_config(tmp, leg, device, DEVICE_HASH=device_hash,
                      DESIRED_MAX_TX_PER_LEDGER=2 * NODE_TXS, INVARIANT_SAMPLED=True)
    _node_counts(reset=True)
    # REAL_TIME: the closes are driven synchronously and the spans must
    # carry wall time (a virtual clock stands still between cranks)
    app = Application.create(VirtualClock(REAL_TIME), cfg, new_db=True)
    if device == "cpu":
        # the plain verify of a 4096-lane chunk on the CPU outlasts the
        # card's dispatch budget (15 s): give the plain leg room instead
        # of a stall
        inner = app.sig_backend.inner
        inner.DEVICE_TIMEOUT = inner.DEVICE_FIRST_TIMEOUT = PLAIN_DISPATCH_BUDGET_S
    lm = app.ledger_manager
    hashes = []

    def check(frames):
        ts = TxSetFrame(lm.last_closed.hash, frames)
        ts.sort_for_hash()
        t0 = time.perf_counter()
        ok = ts.check_valid(app)
        return ts, ok, t0

    def commit(ts, upgrades=()):
        sv = StellarValue(ts.get_contents_hash(), lm.last_closed.header.scpValue.closeTime + 5,
                          list(upgrades), 0)
        lm.close_ledger(LedgerCloseData(lm.current.header.ledgerSeq, ts, sv))
        hashes.append(lm.last_closed.hash.hex())

    try:
        t_setup = time.perf_counter()
        up = [xdr_to_opaque(LedgerUpgrade(LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE,
                                          2 * NODE_TXS))]
        for envs in load.create_ledgers:
            ts, ok, _ = check(load.frames(envs))
            assert ok, f"{leg}: an account-creation txset is invalid"
            commit(ts, up)
            up = []
        setup_s = time.perf_counter() - t_setup
        app.tracer.clear()
        rounds = [load.frames(envs) for envs in load.rounds]
        times = []
        for r in range(NODE_ROUNDS):
            ts, ok, t0 = check(rounds[r])
            if device == "cuda" and r + 1 < NODE_ROUNDS + untimed_close:
                app.close_pipeline.note_upcoming(rounds[r + 1])
            commit(ts)
            times.append(time.perf_counter() - t0)
            assert ok == (r != NODE_BAD_ROUND), f"{leg}: payment round {r}'s txset check: {ok}"
        bad_tx = rounds[NODE_BAD_ROUND][NODE_BAD_INDEX].get_result_code().name
        spans = {name: agg["p50_ms"] for name, agg in app.tracer.aggregates().items()
                 if name.startswith(("close.", "sig.", "ledger.", "txset."))}
        if untimed_close:
            ts, ok, _ = check(rounds[NODE_ROUNDS])
            assert ok, f"{leg}: the untimed round is invalid"
            commit(ts)
        counts = _node_counts()
        stats = app.sig_backend.stats()
        applied = app.database.query_one("SELECT COUNT(*) FROM txhistory")[0]
    finally:
        app.graceful_stop()
    line = {
        "phase": "node_close", "leg": leg, "device": device, "device_hash": device_hash,
        "accounts": NODE_ACCOUNTS, "txs_per_close": NODE_TXS, "timed_closes": len(times),
        "close_ms": [t * 1e3 for t in times], "p50_ms": _p(times, 0.5) * 1e3,
        "p95_ms": _p(times, 0.95) * 1e3, "span_p50_ms": spans, "setup_s": setup_s,
        "txs_applied": applied, "bad_tx": bad_tx, **counts, "stalls": _stalls(stats),
        "cpu_cutover_items": stats["cpu_cutover_items"], "ledger_hashes": hashes,
        "pipeline": app.close_pipeline.stats(),
    }
    emit(line)
    return line


def phase_node_close(fx, tmp):
    """``node_close``: BASELINE.md's 5000-tx single-signer ledger through a
    standalone validator, three legs on one set of envelopes: the card with
    host hashing, the card with DEVICE_HASH, and the plain versions on the
    CPU (timed closes only).  Header hashes equal across the legs, and the
    payment with the flipped signature byte fails txBAD_AUTH on each."""
    from stellar_tpu_torch.crypto import sha256
    from stellar_tpu_torch.tx import testutils as T

    t0 = time.perf_counter()
    network_id = sha256(T.TEST_PASSPHRASE.encode())
    load = NodeCloseLoad(fx, network_id, fee=NODE_BASE_FEE)
    emit({"phase": "node_close", "fixtures_s": time.perf_counter() - t0,
          "signatures": NODE_TXS * (NODE_ROUNDS + 1), "libsodium": fx.sodium})
    card = node_close_leg(load, tmp, "card", "cuda", False, untimed_close=True)
    card_dh = node_close_leg(load, tmp, "card_device_hash", "cuda", True, untimed_close=True)
    plain = node_close_leg(load, tmp, "plain", "cpu", False, untimed_close=False)
    n_timed = len(load.create_ledgers) + NODE_ROUNDS
    assert card["ledger_hashes"] == card_dh["ledger_hashes"], "card legs disagree"
    assert card["ledger_hashes"][:n_timed] == plain["ledger_hashes"], "card and plain disagree"
    assert [ln["bad_tx"] for ln in (card, card_dh, plain)] == ["txBAD_AUTH"] * 3
    for line in (card, card_dh):
        assert line["launches"]["ed25519_verify"] > 0, f"{line['leg']}: no verify launch"
        assert line["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, line["plain_calls"]
        assert line["stalls"] == 0 and line["cpu_cutover_items"] == 0, line
        n_create = sum(len(envs) for envs in load.create_ledgers)
        assert line["txs_applied"] == n_create + NODE_TXS * (NODE_ROUNDS + 1), line["txs_applied"]
    assert card["launches"]["sha512_h"] == 0 and card_dh["launches"]["sha512_h"] > 0
    assert plain["launches"]["ed25519_verify"] == 0 and plain["plain_calls"]["ed25519"] > 0
    emit({"phase": "node_close", "hashes_equal": True, "bad_tx": "txBAD_AUTH",
          "ledgers": len(card["ledger_hashes"]),
          "p50_ms": {ln["leg"]: ln["p50_ms"] for ln in (card, card_dh, plain)}})
    return {"ed25519_verify": card["launches"]["ed25519_verify"] + card_dh["launches"]["ed25519_verify"],
            "sha512_h": card_dh["launches"]["sha512_h"]}


def consensus_run(tmp, tag, device, n_accounts, n_txs, rate, bucket_hash_node=None):
    """Three validators (threshold 2, all running, CoreTests.cpp:46) over the
    loopback overlay on one virtual clock, a ``LoadGenerator(seed=1337)``
    load on the first; cranked until the load is submitted and every node
    has closed CONSENSUS_LEDGERS, then two more ledgers so the submitted
    txs apply.  Returns the ledger hashes (per node), counts and stats."""
    from stellar_tpu_torch.bucket import hashplane
    from stellar_tpu_torch.crypto.keys import SecretKey
    from stellar_tpu_torch.ledger.headerframe import LedgerHeaderFrame
    from stellar_tpu_torch.simulation import OVER_LOOPBACK, LoadGenerator, Simulation
    from stellar_tpu_torch.tx import testutils as T
    from stellar_tpu_torch.xdr.scp import SCPQuorumSet

    _node_counts(reset=True)
    keys = [SecretKey.pseudo_random_for_testing(i + 1) for i in range(3)]
    qset = SCPQuorumSet(2, [k.get_public_key() for k in keys], [])
    sim = Simulation(OVER_LOOPBACK)
    for i, k in enumerate(keys):
        cfg = T.get_test_config(sim._next_instance, backend="gpu")
        cfg.SIG_DEVICE = device
        cfg.SIG_BATCH_MAX = LANES
        cfg.DEVICE_BUCKET_HASH = i == bucket_hash_node
        cfg.BUCKET_DIR_PATH = os.path.join(tmp, tag, f"buckets{i}")
        cfg.TMP_DIR_PATH = os.path.join(tmp, tag, f"tmp{i}")
        sim.add_node(k, qset, cfg=cfg)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        sim.add_pending_connection(keys[a], keys[b])
    t0 = time.perf_counter()
    try:
        sim.start_all_nodes()
        app = sim.get_node(keys[0])
        lg = LoadGenerator(seed=1337)
        lg.generate_load(app, n_accounts, n_txs, rate=rate)
        ok = sim.crank_until(
            lambda: lg.is_done() and sim.have_all_externalized(CONSENSUS_LEDGERS), 3600)
        assert ok, f"{tag}: nodes stuck at {sim.ledger_nums()}"
        last = min(sim.ledger_nums()) + 2
        assert sim.crank_until(lambda: sim.have_all_externalized(last), 600), sim.ledger_nums()
        wall = time.perf_counter() - t0
        assert sim.all_ledgers_agree(), f"{tag}: the nodes disagree"
        top = min(sim.ledger_nums())
        hashes = [[LedgerHeaderFrame.load_by_sequence(n.database, s).get_hash().hex()
                   for s in range(2, top + 1)] for n in sim.nodes.values()]
        counts = _node_counts()
        stats = [n.sig_backend.stats() for n in sim.nodes.values()]
        applied = [n.database.query_one("SELECT COUNT(*) FROM txhistory")[0]
                   for n in sim.nodes.values()]
        bucket_backends = [hashplane.get_backend(n.config).name for n in sim.nodes.values()]
    finally:
        sim.stop_all_nodes()
    return {"hashes": hashes, "counts": counts, "stats": stats, "applied": applied,
            "wall_s": wall, "virtual_s": sim.clock.now(), "ledgers": top,
            "bucket_backends": bucket_backends}


class VerifyTap:
    """While installed, every verify kernel launch keeps a copy of its
    input chunk and its verdicts (on the card, on the launch's stream), so
    a run's verdicts can be held against the plain version afterwards.  It
    wraps the wrapper: the launch count is the wrapper's own."""

    def __init__(self):
        from stellar_tpu_torch.ops import ed25519_cuda

        self.mod = ed25519_cuda
        self.launch = ed25519_cuda.verify_packed
        self.calls = []

    def __enter__(self):
        def tapped(p):
            out = self.launch(p)
            self.calls.append((p.clone(), out.clone()))
            return out

        self.mod.verify_packed = tapped
        return self

    def __exit__(self, *exc):
        self.mod.verify_packed = self.launch

    def check(self):
        """The plain version over every kept chunk, in LANES-lane calls on
        the card: lanes, accepts, mismatches and seconds."""
        import torch

        from stellar_tpu_torch.ops import ed25519 as ed

        torch.cuda.synchronize()
        packed = torch.cat([p for p, _ in self.calls], dim=1)
        kernel = torch.cat([v for _, v in self.calls])
        t0 = time.perf_counter()
        plain = torch.cat([ed._verify_packed(packed[:, i:i + LANES].contiguous())
                           for i in range(0, packed.shape[1], LANES)])
        torch.cuda.synchronize()
        return {"launches": len(self.calls), "lanes": int(packed.shape[1]),
                "accepts": int(kernel.sum()), "mismatches": int((kernel != plain).sum()),
                "plain_s": time.perf_counter() - t0}


def phase_node_consensus(tmp):
    """``node_consensus``: three validators on the card under a
    CONSENSUS_ACCOUNTS-account, CONSENSUS_TXS-payment load, the first node
    with DEVICE_BUCKET_HASH (B3 in the node), every verify launch's verdicts
    held against the plain version afterwards; then a smaller load of the
    same seeded run on the card and on the plain versions, hash for hash
    (the plain version costs ~1 s a call on the CPU whatever the batch, and
    the full load makes ~1350 calls)."""
    with VerifyTap() as tap:
        full = consensus_run(tmp, "consensus", "cuda", CONSENSUS_ACCOUNTS, CONSENSUS_TXS,
                             CONSENSUS_RATE, bucket_hash_node=0)
    c = full["counts"]
    emit({"phase": "node_consensus", "run": "card", "accounts": CONSENSUS_ACCOUNTS,
          "payments": CONSENSUS_TXS, "ledgers": full["ledgers"], "txs_applied": full["applied"],
          "wall_s": full["wall_s"], "virtual_s": full["virtual_s"], **c,
          "stalls": sum(_stalls(st) for st in full["stats"]),
          "device_calls": [st["device_calls"] for st in full["stats"]],
          "bucket_backends": full["bucket_backends"], "ledger_hashes": full["hashes"][0]})
    assert full["ledgers"] >= CONSENSUS_LEDGERS
    assert all(h == full["hashes"][0] for h in full["hashes"])
    assert c["launches"]["ed25519_verify"] > 0 and c["launches"]["sha256_frames"] > 0, c
    assert c["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, c
    assert all(_stalls(st) == 0 for st in full["stats"])
    assert full["bucket_backends"] == ["device-cuda", "native", "native"], full["bucket_backends"]
    verdicts = tap.check()
    emit({"phase": "node_consensus", "run": "card", "verdicts_vs_plain": verdicts})
    assert verdicts["launches"] == c["launches"]["ed25519_verify"], verdicts
    assert verdicts["mismatches"] == 0, verdicts
    pair = {}
    for device in ("cuda", "cpu"):
        run = consensus_run(tmp, f"pair-{device}", device, PAIR_ACCOUNTS, PAIR_TXS, PAIR_RATE)
        pair[device] = run
        emit({"phase": "node_consensus", "run": f"pair_{device}", "accounts": PAIR_ACCOUNTS,
              "payments": PAIR_TXS, "ledgers": run["ledgers"], "txs_applied": run["applied"],
              "wall_s": run["wall_s"], **run["counts"],
              "stalls": sum(_stalls(st) for st in run["stats"]),
              "ledger_hashes": run["hashes"][0]})
    n = min(pair["cuda"]["ledgers"], pair["cpu"]["ledgers"]) - 1
    assert n >= CONSENSUS_LEDGERS - 1
    assert [h[:n] for h in pair["cuda"]["hashes"]] == [h[:n] for h in pair["cpu"]["hashes"]]
    assert pair["cpu"]["counts"]["launches"]["ed25519_verify"] == 0
    assert pair["cpu"]["counts"]["plain_calls"]["ed25519"] > 0
    emit({"phase": "node_consensus", "pair_hashes_equal": n})
    return {"ed25519_verify": c["launches"]["ed25519_verify"],
            "sha256_frames": c["launches"]["sha256_frames"]}


def sass_instructions(lib: str):
    """Machine instructions in the built library (cuobjdump), or None where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120)
    # an instruction line starts with its address: /*0a70*/
    return len(re.findall(r"^\s*/\*[0-9a-f]{4,}\*/", r.stdout, re.M))


def phase_build():
    """Build the three kernel libraries and the C host stage, all at once."""
    from stellar_tpu_torch import native
    from stellar_tpu_torch.ops import ed25519_cuda, sha256_cuda, sha512_cuda

    mods = {"ed25519_verify": ed25519_cuda, "sha512_h": sha512_cuda, "sha256_frames": sha256_cuda}

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(mods) + 1) as ex:
        futs = {name: ex.submit(timed, m.load_library) for name, m in mods.items()}
        # the C host stage and the node's C engines (bucket merge, XDR
        # codec, apply leg, half-aggregation): none may build inside a close
        engines = {}
        host = ex.submit(timed, lambda: engines.update(native.build_all()))
        secs = {name: f.result() for name, f in futs.items()}
        sighash_s = host.result()
    assert all(engines.values()), f"a C engine did not build: {engines}"
    kernels = {}
    for name, m in mods.items():
        with open(m.library_path()[:-3] + ".log") as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        kernels[name] = {"s": secs[name], "ptxas": ptxas,
                         "sass_instructions": sass_instructions(m.library_path())}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "host_engines_s": sighash_s,
          "host_engines": engines, "kernels": kernels})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from stellar_tpu_torch.bucket import hashplane
        from stellar_tpu_torch.crypto import sodium  # noqa: F401
        from stellar_tpu_torch.ops import ed25519 as ed
        from stellar_tpu_torch.ops import ed25519_cuda as ec
    except ImportError as e:
        print(f"chip_smoke: the stellar_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2
    from concurrent.futures import ProcessPoolExecutor

    import multiprocessing as mp

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi})

    phase_build()

    rng = random.Random(SEED)
    with ProcessPoolExecutor(
        max_workers=os.cpu_count() or 1, mp_context=mp.get_context("spawn")
    ) as pool:
        fx = Fixtures(pool)
        t0 = time.perf_counter()

        def tx_hashes(tag):
            return lambda k: [hashlib.sha256(b"%s tx %d" % (tag.encode(), k)).digest()]

        ledger1 = make_load(fx, rng, "ledger1", LEDGER_TXS, tx_hashes("l1"))
        # ledger N+1: the same accounts, new transactions (the prewarm)
        ledger2 = make_load(fx, rng, "ledger1", LEDGER_TXS, tx_hashes("l2"))
        # 1000 txs, 5 signer keys each, 3 of them sign the tx hash
        ms_jobs = []
        for k in range(5 * MULTISIG_TXS):
            tx, slot = divmod(k, 5)
            ms_jobs.append([hashlib.sha256(b"multisig tx %d" % tx).digest()] if slot < 3 else [])
        multisig = make_load(fx, rng, "multisig", 5 * MULTISIG_TXS, lambda k: ms_jobs[k])
        scp_rng = random.Random(SEED + 1)
        scp_msgs = [
            bytes(scp_rng.getrandbits(8) for _ in range(scp_rng.randrange(100, 301)))
            for _ in range(SCP_ENVELOPES)
        ]
        scp = make_load(fx, rng, "validator", SCP_ENVELOPES, lambda k: [scp_msgs[k]])
        t1 = time.perf_counter()
        buf, frame_len = bucket_buffer(SEED)
        frames = hashplane.split_frames(buf)
        emit({"phase": "fixtures", "seconds": time.perf_counter() - t0,
              "libsodium": fx.sodium, "bucket_seconds": time.perf_counter() - t1,
              "bucket_bytes": len(buf), "bucket_records": len(frames)})

        floor_ms = launch_floor_ms()
        emit({"phase": "kernels", "name": "noop", "launch_floor_ms": floor_ms})
        rows = [
            phase_kernels(rng, ledger1[0]),
            phase_kernel_sha512(rng, ledger1[0]),
            phase_kernel_sha256(frames, frame_len),
        ]

        def sync(backend, items, caller):
            return backend.verify_batch(items, caller=caller)

        def async_(backend, items, caller):
            return backend.verify_batch_async(items, caller=caller).result()

        valid1 = [it for it, ok in zip(*ledger1) if ok]

        def loads(backend):
            yield ("ledger_5000tx", "close", *ledger1, sync)
            yield ("ledger_5000tx_next", "pipeline", *ledger2, async_)
            yield ("multisig_1000tx_3of5", "close", *multisig, sync)
            yield ("scp_300", "overlay", *scp, sync)

        backend, launches, host_loads = phase_main(fx, rng, loads)
        # (d): ledger (a)'s valid signatures again — the cache latches valid
        # verdicts only, so every lane is a hit and nothing launches
        ec.launches = 0
        ed.plain_calls = 0
        t0 = time.perf_counter()
        got = backend.verify_batch(valid1, caller="close")
        sec = time.perf_counter() - t0
        assert got == [True] * len(valid1) and ec.launches == 0 and ed.plain_calls == 0
        emit({"phase": "main_path", "load": "ledger_5000tx_replay", "signatures": len(valid1),
              "cache_hits": len(valid1), "launches": ec.launches, "ms": sec * 1e3})

        _, dh_launches, dh_loads = phase_main(fx, rng, loads, device_hash=True)
        for name, host in host_loads.items():
            emit({"phase": "main_path_compare", "load": name,
                  "host_hash": host, "device_hash": dh_loads[name]})

        phase_torsion(fx, rng, backend, [it[0] for it in ledger1[0][:TORSION_ENCS]])

        with tempfile.TemporaryDirectory(prefix="chip_smoke_node_") as tmp:
            close_launches = phase_node_close(fx, tmp)

    bucket_launches = phase_bucket(buf, frames)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_node_") as tmp:
        consensus_launches = phase_node_consensus(tmp)

    rows[0]["launches"] = launches["ed25519_verify"]
    rows[1]["launches"] = dh_launches["sha512_h"]
    rows[2]["launches"] = bucket_launches
    # each path's own count, set to 0 just before it and read just after
    rows[0]["launches_by_path"] = {"main_path": launches["ed25519_verify"],
                                   "node_close": close_launches["ed25519_verify"],
                                   "node_consensus": consensus_launches["ed25519_verify"]}
    rows[1]["launches_by_path"] = {"main_path_device_hash": dh_launches["sha512_h"],
                                   "node_close": close_launches["sha512_h"]}
    rows[2]["launches_by_path"] = {"bucket_hash": bucket_launches,
                                   "node_consensus": consensus_launches["sha256_frames"]}
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err",
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: row[k] for k in keys}, "launch_floor_ms": floor_ms}
                                  for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
