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
                raw classes, both verdict classes present; then the first n
                lanes for n in NODE_WIDTHS (1, 3, 16, 64: the widths the
                node's consensus and flood launches have) and TAIL_LANES
                (904, a 5000-tx ledger's tail chunk; 300, an SCP flush),
                each held against the slice of the 4096-lane plain verdicts
                and timed beside the bound of n verifies and the launch
                floor (``widths``), and the 4096 lanes 8 times over
                (32768); the row names the kernel's threads per signature
                and block size;
              - ed25519_verify_signed and ed25519_verify_signed_pair: the
                signed-digit windows' two kernels
                (``STELLAR_TPU_SIGNED_WINDOWS``; the wide variant, the
                signed instance of the unsigned kernel's template, and the
                pair, a chain warp and a comb warp for narrow launches,
                picked by ``ed25519_cuda.signed_variant``), each forced on
                the same lanes, widths and wide shape, held against the
                signed plain version, and on 64 raw-carry lanes (valid
                signatures whose s or h is raised by a multiple of L past
                0x77…78: the unsigned kernel accepts them, both signed ones
                drop the window-63 carry and reject them, as the JAX kernel
                does); the three kernels graph-timed in turns on the same
                lanes at 4096 and 32768, and each one's registers, shared
                memory and resident blocks an SM from the CUDA runtime; the
                wide variant's row at 4096 lanes, the pair's at one;
              - dh_rows_to_cols (T1): 32,768 device-hash lanes staged
                item-major by ``stage_rows`` (every single-block message
                length 0-47, host-hashed longer messages, gate-rejected
                inert lanes) into the (160, n) layout, and the first n of
                them for n in TRANSPOSE_WIDTHS, each from an aligned and a
                misaligned input (the byte path) and once replayed from a
                CUDA graph; each equal to the plain version and to
                ``stage_raw``'s buffer of the same items, timed beside
                PyTorch's own transpose (``library_ms``);
              - sha512_h: the first 4096 of T1's lanes on the card, as the
                verify plane feeds B2, into a new tensor and in place; an
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
              ``stage_rows`` and merged through the flag row; every chunk
              is staged item-major and transposed by T1, one T1 launch a
              B1 launch.  Same verdict checks; the kernels must have
              launched and neither plain version run; span sums beside the
              host-hash run's;
5b. bench   — ``bench``: the port's headline bench (``python -m
              stellar_tpu_torch.bench``), its ``main()`` in process at full
              width (``BENCH_BATCH=32768``, ``BENCH_CHUNKS=4``) with
              ``BENCH_SKIP_CLOSE=1`` and ``BENCH_SCENARIOS=0`` (the close
              and the chaos plane run in the node phases below): the
              headline, two-stream, Python host-stage and device-hash
              legs, the SCP envelope legs and the byzantine flood on the
              card.  Its one JSON line is the phase's row, beside the
              launch counts read around the call (set to 0 just before);
              the first launch of each leg (B1, and T1 and B2 in the
              device-hash leg) is held against the plain version on the card
              afterwards.  Fails on an ``error`` or any ``*_error`` in the
              line, a zero ``value``, a plain call, or a mismatch;
5c. profilers — ``profilers``: the port's close and state profilers
              (``python -m stellar_tpu_torch.profile_close`` /
              ``profile_system``) in process at full width:
              ``pipeline_report(5000, 3)`` (the paired close-pipeline
              report, PARANOID, invariants all-on, its legs bit-exact; the
              prewarm's dispatched and joined counts), the state ladder's
              top rung ``_rung(10**6)`` (its three bucket backends hash for
              hash, the device leg over every bucket) and ``hash_ab(64)``
              (its 2x gate a field, ``gate_ok``, not a failure).  Launch
              counts read around each call; the first and widest B1 launch
              and the first launch of each B3 kernel of each call held
              against the plain versions; fails on any exception, mismatch,
              stall, plain call or zero launch count;
5d. profile_kernel — ``profile_kernel``: the port's kernel profiler and
              driver entry (``python -m stellar_tpu_torch.profile_kernel`` /
              ``graft_entry``) in process at their defaults:
              ``graft_entry.entry()`` (16 mixed lanes through B1, verdicts
              equal to the mask) and ``dryrun_multichip(2)`` (two cards, or
              the repeated-device rig on one), ``profile_kernel.main(32768,
              ab=True)`` (device-only B1 / wide B1s / B1 and the signed
              windows' gain), ``device_hash_ab(8192, 3)`` (kernel-only against
              the host-hash and device-hash rates end to end; its 0.9 gate's
              rc a field) and ``mesh_curve([1, 2, 4], 2048, 3)`` on the rig
              (one child process a leg, each printing its own launches and
              plain calls by kernel; the retention gate's rc a field).
              Launch counts read around each call (the dryrun a path of its
              own); the first launch of each kernel (B1, B1s, T1, B2) on each
              in-process path held against the plain version, the curve's
              legs against the oracle; fails on any exception, wrong
              verdict, failed leg, mismatch, plain call (the legs' too) or
              zero launch count;
6. torsion  — ``torsion_check`` on 512 encodings against
              ``ref25519.is_torsion_free``, and the host path (the
              ``native/halfagg.c`` ladder, what the cpu backend and a batch
              below the cutover run) equal to the card on the same
              encodings;
7. mesh     — ``mesh``: the sharded verify path (``parallel/mesh.py``) on
              the one card.  On a one-card host ``mesh_from_spec("auto")``
              is None and a node config with ``SIG_MESH = 2`` refuses the
              boot.  Then ``make_sharded_verifier`` over the repeated-device
              meshes ``[cuda:0] * 2`` and ``[cuda:0] * 3`` (the test rig: own
              buffers, streams and launches a shard, on one card), with and
              without device hashing, on the 5000-tx ledger, the 300 SCP
              envelopes, a 43-lane remainder of mixed and hostile lanes (the
              tail shard short, a dead shard on three) and the 512 torsion
              encodings: verdicts equal the unsharded verifier's in the same
              call and the known ones; one B1 launch (and under device
              hashing one T1 launch a verify chunk, and for single-block
              messages one B2 launch) a live shard and none for a dead one; every shard's launch held against the
              plain version on its inputs afterwards; ms per load beside the
              unsharded verifier's, in turns.  With two cards or more the
              same on ``[cuda:0, cuda:1]``; else ``"multi_card": "not run:
              1 card"``;
8. bucket hash — the port's ``bucket/hashplane`` on a seeded framed
              buffer of 10^6 records (~108 MB, the 10^6-account rung of
              STATE_LADDER_r22.json): ``hash_frames`` over the whole buffer
              and ``BucketHasher`` frame by frame, each through the device,
              native and hashlib backends — all six hashes equal; both
              SHA-256 kernels launched in each of the two device runs (the
              lane kernel on the bucket's two-block class, the pair on the
              narrow classes) and the plain version did not run; launches
              by kernel, MB/s per backend and the device backend's spans;
9. node close — ``node_close``: BASELINE.md's 5000-tx single-signer ledger
              through a standalone validator (``Application`` →
              ``TxSetFrame.check_valid`` → ``LedgerManager.close_ledger``,
              ``SIGNATURE_BACKEND = "gpu"``, 4096-lane chunks): 5001
              accounts created, then three timed closes of 5000 payments
              from distinct accounts and one untimed close, in three legs
              on one set of pre-signed envelopes — the card with host
              hashing, the card with ``DEVICE_HASH``, and the plain versions
              on the CPU (``SIG_DEVICE = "cpu"``, the first two timed closes
              only: a plain close costs ~25-37 s of CPU).  One
              payment of the second timed round carries a flipped signature
              byte: that round's txset check fails and the payment fails
              ``txBAD_AUTH`` on every leg.  Per leg: close ms (p50, p95),
              the close and flush spans' p50s, the kernels' launches, the
              plain versions' calls (0 on the card legs), eager ref25519
              verifies and stalls (0).  Every header hash equal across the
              legs.  A fourth leg, ``card_mesh2``, boots with ``SIG_MESH =
              "auto"`` on a host whose ``local_devices`` lists the card
              twice: the verify plane two shards wide, header hashes equal
              to the card leg's, 0 stalls; with two cards or more, a fifth,
              ``card_mesh_cards``, the same over all of them.  The leg
              ``card_signed`` runs the card leg with the signed-digit
              windows (the module constant ``ops/ed25519.py::_SIGNED_WIN``
              set for the leg and restored after it): header hashes equal
              to the card leg's, every verify launch a signed one of the
              kernel ``signed_variant`` picks, no plain call, 0 stalls.
              Every leg's line has its ``launch_widths`` (lanes: calls of
              the verify wrapper);
10. node consensus — ``node_consensus``: three validators (threshold 2, all
              running) over the loopback overlay, all on the card, under a
              seeded 300-account, 1000-payment ``LoadGenerator`` load, the
              first node with ``DEVICE_BUCKET_HASH`` (the SHA-256 kernel in
              the bucket list): every node past ledger 5, all agreeing,
              launches > 0, no stall.  Every verify kernel launch of that
              run keeps its input chunk and verdicts, and afterwards the
              plain version verifies all of them again on the card: zero
              mismatches; the launches' ``launch_widths``.  Then
              ``card_signed``: the same load with the signed-digit windows
              (``_SIGNED_WIN`` set for the run and its check): hash for hash
              with the card run, no unsigned launch, pair launches > 0 (the
              kernel of ``signed_variant`` at each width), 0 stalls, and
              every launch equal to the signed plain version.  Then the
              same seeded run at 10 accounts and 40
              payments on the card and on the plain versions on the CPU,
              hash for hash (the plain version costs about a second a call
              on the CPU whatever the batch, and the full load makes ~1350
              calls);
11. scenario flood — ``scenario_flood``: the chaos matrix's
              ``byzantine_flood_gpu`` at its big spec (a 4-core + 4-tier
              ring, 1200 load txs, 50 invalid envelopes and 10 invalid txs
              every 0.4 s from 0.5 s to 20 s on node 0), every node on the
              gpu backend at cutover 0 on the card: the scenario's floors
              (ledgers agree, every flooded envelope rejected, the cache
              unpolluted), device dispatches under the ``overlay`` caller
              (``device_dispatches`` in the backends' stats), no plain
              call, no stall, and every launch's verdicts held against the
              plain version on the card afterwards; the launches'
              ``launch_widths``;
12. fuzz    — ``--genfuzz`` then ``--fuzz`` through ``python -m
              stellar_tpu_torch.main.cli`` (its node pair on the card):
              both exit 0.

Every phase fails on a dispatch that outlived its budget
(``stalled_items``), one the card never answered
(``stall_rejected_items``) or a latch flip: no batch ever leaves the card
for the host, and the card's runs hide no stall.  Then, on lines
of their own: the kernels' JSON line, the nvidia-smi line,
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
# the device-hash chunk of the benchmark's cell and of the bench
# (SIG_BATCH_MAX = 32768), T1's main shape; and its narrower launches: one
# lane, a width past no multiple of 4 (T1's byte path), a 5000-tx ledger's
# tail, the node's chunk and one lane more
DH_CHUNK_LANES = LANES * WIDE_FACTOR
TRANSPOSE_WIDTHS = (1, 63, 904, LANES, LANES + 1)
# the verify kernel's ragged chunks: a 5000-tx ledger's tail (5000 - 4096)
# and a 300-envelope SCP flush
TAIL_LANES = (904, 300)
# the widths the node's busiest paths launch the verify kernel at
# (node_consensus ~1 lane a launch, scenario_flood ~2.6: their
# launch_widths), timed beside the chunk widths
NODE_WIDTHS = (1, 3, 16, 64)
# bound of the verify kernel (csrc/ed25519_verify.cu header note): field
# squarings and multiplications per lane of the JAX kernel's algorithm (64
# windows, the table of k·(-A), decompress, compress) — the same work
# whatever the kernel skips (it no longer compresses) — and 32-bit integer multiply-adds (low + high half
# each) per 255-bit operation on 8 words: 8x8 word products for a
# multiplication, 36 for a squaring, plus 8 for the x38 fold of the reduction
FIELD_SQRS_PER_VERIFY = 64 * 16 + 255 + 254
FIELD_MULS_PER_VERIFY = 64 * 28 + 142 + 18 + 13
# the signed-digit windows build the table to k = 8 only: 7 general adds of
# 9M, 8 x 2d·T and -A's T (72M against 142M); the windows are the same
FIELD_MULS_PER_VERIFY_SIGNED = 64 * 28 + 72 + 18 + 13
# the least 256-bit scalar whose signed recode carries out of window 63
RAW_CARRY = 2**256 - int("88" * 32, 16)
RAW_CARRY_LANES = 64
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
# blocks a lane of the SHA-256 kernel's one-warp chain shapes (chain_k)
SHA256_CHAINS = (2, 4, 5)
# the names some SHA-256 kernel shapes had in earlier runs
SHA256_OLD_NAMES = {"bucket_class2": "class_2_blocks"}
# the SHA-256 source's two kernels (ops/sha256_cuda.VARIANTS), as the
# kernels line names them
SHA256_KERNELS = {"lane": "sha256_frames", "pair": "sha256_frames_pair"}
# node_close: BASELINE.md's 5000-tx single-signer ledger (bench.py's shape):
# 5001 accounts, 100 creates a tx and 2000 a ledger, then timed rounds of
# 5000 payments and one untimed round; the genesis base fee
NODE_TXS = LEDGER_TXS
NODE_ACCOUNTS = NODE_TXS + 1
NODE_CREATE_PER_TX = 100
NODE_CREATE_PER_LEDGER = 2000
NODE_ROUNDS = 3
# the plain leg's timed closes: through the flipped-signature round (each
# plain close costs ~25-37 s of CPU, and the script's time limit is fixed)
NODE_PLAIN_ROUNDS = 2
NODE_BASE_FEE = 100
# the payment of a timed round whose signature carries a flipped byte
NODE_BAD_ROUND, NODE_BAD_INDEX = 1, 2500
PLAIN_DISPATCH_BUDGET_S = 900.0
# node_consensus: three validators under a seeded LoadGenerator load; the
# card-and-plain pair at a smaller load of the same seeded run
CONSENSUS_ACCOUNTS, CONSENSUS_TXS, CONSENSUS_RATE = 300, 1000, 100
PAIR_ACCOUNTS, PAIR_TXS, PAIR_RATE = 10, 40, 10
CONSENSUS_LEDGERS = 5
# scenario_flood: the chaos plane's gpu flood class, at its big spec
FLOOD_CLASS = "byzantine_flood_gpu"
# mesh: the repeated-device meshes on one card, the remainder load's lanes,
# and the timed calls of each load on each verifier (in turns)
MESH_SHARDS = (2, 3)
MESH_REMAINDER = 43
MESH_REPS = 5
# bench: the port's bench at the headline's full width; the close and the
# chaos plane are driven by node_close and scenario_flood
BENCH_KNOBS = {"BENCH_BATCH": "32768", "BENCH_CHUNKS": "4", "BENCH_SKIP_CLOSE": "1",
               "BENCH_SCENARIOS": "0", "BENCH_WATCHDOG": "600"}
# the bench's stages (bench._progress["stage"]) that must launch B1 on the
# card: the headline (its untimed first pass), the A/B legs, the SCP
# envelopes through GpuSigBackend and the flood through the node's overlay path
BENCH_B1_STAGES = ("warmup", "verify-2stream", "verify-python-hoststage", "verify-device-hash",
                   "scp-envelopes-gpu", "byzantine-flood")
# profilers: the port's close and state profilers at the sizes operators
# run — the close pipeline's paired report over 5000-tx closes, the state
# ladder's top rung (10^6 accounts, ~100 MB of buckets; the device leg's
# default byte budget covers every bucket) and the bucket-hash A/B's 64 MB
PIPELINE_TXS, PIPELINE_LEDGERS = 5000, 3
LADDER_ACCOUNTS = 1_000_000
HASH_AB_MB = 64
# profile_kernel: the port's kernel profiler and driver entry at their
# defaults — main's A/B/A at 32,768 lanes (the wide B1s there), the
# device-hash A/B at 8192 lanes and 3 reps, the rig's curve over 1, 2 and 4
# shards of 2048 lanes, the dryrun over two shards
KERNEL_PROFILE_LANES = 32768
DEVICE_HASH_AB_LANES, DEVICE_HASH_AB_REPS = 8192, 3
MESH_CURVE_COUNTS, MESH_CURVE_PER_CHIP, MESH_CURVE_REPS = (1, 2, 4), 2048, 3
DRYRUN_SHARDS = 2
REPO = os.path.dirname(os.path.abspath(__file__))


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


def verify_bound(lanes, signed):
    """(bound ms, what bounds it) of ``lanes`` verifies: the JAX kernel's
    integer multiply-adds over the card's INT32 rate, or each lane's 128
    packed bytes read and verdict written over its memory rate."""
    muls = FIELD_MULS_PER_VERIFY_SIGNED if signed else FIELD_MULS_PER_VERIFY
    imads = muls * IMAD_PER_FIELD_MUL + FIELD_SQRS_PER_VERIFY * IMAD_PER_FIELD_SQR
    ops_s = lanes * imads / H100_IMAD_PER_S
    bytes_s = lanes * (128 + 1) / H100_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def verify_widths(fn, packed, plain, signed, floor_ms, widths=NODE_WIDTHS + TAIL_LANES):
    """``fn`` on the first n lanes of ``packed`` for each n of ``widths``:
    held against the first n plain verdicts, graph-timed, beside the bound
    of n verifies and the launch floor."""
    out = {}
    for n in widths:
        part = packed[:, :n].contiguous()
        bad = int((fn(part) != plain[:n]).sum())
        assert bad == 0, f"kernel disagrees with the plain version on {bad} of the first {n} lanes"
        out[n] = {"mismatches": bad, "accepts": int(plain[:n].sum()),
                  "ms": graph_ms(lambda: fn(part)), "call_ms": cuda_ms(lambda: fn(part), 7),
                  "bound_ms": verify_bound(n, signed)[0], "launch_floor_ms": floor_ms}
    return out


def phase_kernels(rng, ledger_items, floor_ms):
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
    widths = verify_widths(ec.verify_packed, packed, plain, False, floor_ms)
    # the same lanes 8 times over: 4096 lanes fill one warp per scheduler at
    # most; the wide shape shows how the time grows past that
    wide = packed.repeat(1, WIDE_FACTOR).contiguous()
    wide_bad = int((ec.verify_packed(wide) != plain.repeat(WIDE_FACTOR)).sum())
    assert wide_bad == 0, f"kernel disagrees with the plain version on {wide_bad} wide lanes"
    wide_ms = graph_ms(lambda: ec.verify_packed(wide), reps=3)
    wide_call_ms = cuda_ms(lambda: ec.verify_packed(wide), 5)
    threads_per_lane, block_threads = ec.geometry()
    bound_ms, bound_by = verify_bound(LANES, False)
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
        "bound_by": bound_by,
        "library_ms": None,
        "threads_per_lane": threads_per_lane,
        "block_threads": block_threads,
    }
    emit({"phase": "kernels", **row, "widths": widths, "wide_lanes": wide.shape[1],
          "wide_mismatches": wide_bad, "wide_ms": wide_ms, "wide_call_ms": wide_call_ms,
          "wide_bound_ms": verify_bound(wide.shape[1], False)[0], "launch_floor_ms": floor_ms})
    return row, packed


def raw_carry_lanes(packed, accepted, n=RAW_CARRY_LANES):
    """n accepted lanes of the kernel mix's valid class (lane i % 8 == 0)
    with s, or on every fourth lane h, raised by a multiple of L to at
    least RAW_CARRY: the unsigned kernel accepts them (the modular
    identity), the signed one drops the carry out of window 63 and rejects
    them."""
    import numpy as np

    from stellar_tpu_torch.ops import ref25519 as ref

    cols = [i for i in range(0, packed.shape[1], 8) if accepted[i]][:n]
    assert len(cols) == n, f"{len(cols)} accepted lanes of the valid class"
    src = packed[:, cols].cpu().numpy().copy()
    for j in range(n):
        row = 96 if j % 4 == 3 else 64
        v = int.from_bytes(src[row : row + 32, j].tobytes(), "little")
        k = max(k for k in range(16) if v + k * ref.L < 2**256) - j % 3
        v += k * ref.L
        assert v >= RAW_CARRY
        src[row : row + 32, j] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    return src


def phase_kernel_signed(packed, floor_ms):
    """The signed-digit windows' two kernels, ``ed25519_verify_signed`` (the
    wide variant) and ``ed25519_verify_signed_pair`` (the pair), each forced
    and held against the signed plain version on the kernel phase's lanes,
    every width of ``verify_widths``, the wide shape and the raw-carry
    lanes; both with the unsigned kernel graph-timed in turns at 4096 and
    32768 lanes.  Returns the kernels line's rows: the wide variant at 4096
    lanes, the pair at one lane (the node's usual launch, NODE_WIDTHS[0])."""
    import torch

    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    def unsigned(p):
        return ec.verify_packed(p, signed=False)

    kernels = {v: (lambda p, v=v: ec.verify_packed(p, signed=True, variant=v))
               for v in ec.SIGNED_VARIANTS}
    plain = ed._verify_packed(packed, signed=True)
    torch.cuda.synchronize()
    # the valid-signature class (s < L, h mod L): the unsigned verdicts too
    accepted = unsigned(packed)
    raw = torch.from_numpy(raw_carry_lanes(packed, accepted.cpu().tolist())).cuda()
    raw_plain = ed._verify_packed(raw, signed=True)
    assert not raw_plain.any() and unsigned(raw).all(), "the raw-carry lanes do not part the instances"
    wide = packed.repeat(1, WIDE_FACTOR).contiguous()
    checks = {}
    for v, fn in kernels.items():
        got = fn(packed)
        torch.cuda.synchronize()
        bad = int((got != plain).sum())
        assert bad == 0, f"signed {v} kernel disagrees with the signed plain version on {bad} lanes"
        assert torch.equal(got[0::8], accepted[0::8]), f"signed {v} and unsigned part on valid lanes"
        raw_bad = int((fn(raw) != raw_plain).sum())
        assert raw_bad == 0, f"signed {v} kernel disagrees on {raw_bad} raw-carry lanes"
        wide_bad = int((fn(wide) != plain.repeat(WIDE_FACTOR)).sum())
        assert wide_bad == 0, f"signed {v} kernel disagrees on {wide_bad} wide lanes"
        checks[v] = {"mismatches": bad, "max_abs_err": int((got.int() - plain.int()).abs().max()),
                     "raw_carry_mismatches": raw_bad, "wide_mismatches": wide_bad,
                     "widths": verify_widths(fn, packed, plain, True, floor_ms)}
    # the three kernels on the same lanes, in turns: unsigned, wide, pair, pair, wide, unsigned
    turns = {}
    for p, reps in ((packed, 5), (wide, 3)):
        order = [unsigned, kernels["wide"], kernels["pair"]]
        order += order[::-1]
        ms = [graph_ms(lambda: fn(p), reps=reps) for fn in order]
        turns[p.shape[1]] = {"unsigned_ms": [ms[0], ms[5]], "wide_ms": [ms[1], ms[4]],
                             "pair_ms": [ms[2], ms[3]],
                             "wide_over_unsigned": (ms[1] + ms[4]) / (ms[0] + ms[5]),
                             "pair_over_wide": (ms[2] + ms[3]) / (ms[1] + ms[4]),
                             "bound_ms": {"unsigned": verify_bound(p.shape[1], False)[0],
                                          "signed": verify_bound(p.shape[1], True)[0]},
                             "launch_floor_ms": floor_ms}
    emit({"phase": "kernels", "name": "ed25519_verify_signed", "signed": True,
          "raw_carry_lanes": int(raw.shape[1]), "wide_lanes": wide.shape[1], "variants": checks,
          "rule": {n: ec.signed_variant(n) for n in (*NODE_WIDTHS, *TAIL_LANES, LANES)},
          "turns": turns,
          "residency": {"unsigned": ec.residency(False), **ec.residency(True)}})
    rows = []
    for v, name, n in (("wide", "ed25519_verify_signed", LANES),
                       ("pair", "ed25519_verify_signed_pair", NODE_WIDTHS[0])):
        part = packed[:, :n].contiguous()
        bound_ms, bound_by = verify_bound(n, True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "stellar_tpu_torch/csrc/ed25519_verify.cu",
            "replaces": "stellar_tpu/ops/ed25519_pallas.py:171",
            "lanes": n,
            "max_abs_err": checks[v]["max_abs_err"],
            "ms": (statistics.median(turns[LANES][f"{v}_ms"]) if n == LANES
                   else checks[v]["widths"][n]["ms"]),
            "call_ms": cuda_ms(lambda: kernels[v](part), 7),
            "plain_ms": cuda_ms(lambda: ed._verify_packed(part, signed=True), 3),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
        emit({"phase": "kernels", **rows[-1], "variant": v})
    return rows


def sha512_lanes(rng, ledger_items, n=DH_CHUNK_LANES):
    """(n, 160) item-major device-hash lanes staged by the port's
    ``stage_rows``, as the verify plane stages a device-hash chunk, over
    the ledger's items in turn: message lengths 0..59 in turn — 0..47
    upload raw with flag 1, 48..59 are hashed on the host with flag 0 —
    and every 16th lane gate-rejected (s := L: an inert zero lane).
    Returns the rows, the items and the gate verdicts."""
    import numpy as np

    from stellar_tpu_torch import native
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import sha512 as tsha

    items = []
    for i in range(n):
        pk, _, sig = ledger_items[i % len(ledger_items)]
        if i % 16 == 15:
            sig = sig[:32] + tsha.L.to_bytes(32, "little")
        items.append((pk, rng.randbytes(i % 60), sig))
    rows = np.zeros((n, tsha.DH_ROWS), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    rejects, flagged = native.load_sighash().stage_rows(items, 0, n, rows, ok, ed._BLACKLIST, 0)
    assert rejects == n - int(ok.sum()), (rejects, int(ok.sum()))
    assert flagged == int(np.count_nonzero(rows[:, tsha.ROW_FLAG])), flagged
    return rows, items, ok


def phase_kernel_transpose(rows, items, ok, floor_ms):
    """T1, ``dh_rows_to_cols_kernel``, on ``sha512_lanes``' 32,768 staged
    lanes and on the first n of them for n in TRANSPOSE_WIDTHS: each
    output equal to its plain version on the card (``cols_from_rows``) and
    to ``stage_raw``'s (160, n) buffer over the same items; a launch from
    a misaligned input (the byte path), and one captured in a CUDA graph
    and replayed, equal too.  Timed as the other kernels, beside the
    bound (each lane's 160 bytes read and written over the memory rate)
    and ``library_ms``, PyTorch's own transpose (``x.t().contiguous()``)
    timed as ``ms`` is.  Returns the row and the card's (160, n) chunk."""
    import numpy as np
    import torch

    from stellar_tpu_torch import native
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc

    n = rows.shape[0]
    raw = np.zeros((tsha.DH_ROWS, n), dtype=np.uint8)
    raw_ok = np.zeros(n, dtype=np.uint8)
    native.load_sighash().stage_raw(items, 0, n, raw, raw_ok, ed._BLACKLIST, 0)
    assert np.array_equal(raw_ok, ok), "stage_raw and stage_rows disagree on the gate"
    raw = torch.from_numpy(raw).cuda()
    x = torch.from_numpy(rows).cuda()

    def check(part, what):
        launched = sc.transpose_launches
        got = sc.rows_to_cols(part)
        torch.cuda.synchronize()
        assert sc.transpose_launches == launched + 1, f"{what}: T1 did not launch"
        plain = tsha.cols_from_rows(part)
        want = raw[:, : part.shape[0]]
        mismatches = int((got != plain).any(dim=0).sum())
        assert mismatches == 0, f"{what}: T1 disagrees with the plain version on {mismatches} lanes"
        assert torch.equal(got, want), f"{what}: T1's chunk is not stage_raw's"
        return got

    got = check(x, f"{n} lanes")
    widths = {}
    for w in TRANSPOSE_WIDTHS:
        part = x[:w]
        check(part, f"{w} lanes")
        # one byte off the 16-byte alignment: the byte path at any width
        flat = torch.empty(tsha.DH_ROWS * w + 1, dtype=torch.uint8, device=x.device)
        flat[1:].copy_(part.reshape(-1))
        check(flat[1:].view(w, tsha.DH_ROWS), f"{w} lanes, misaligned")
        widths[w] = {"ms": graph_ms(lambda: sc.rows_to_cols(part)),
                     "call_ms": cuda_ms(lambda: sc.rows_to_cols(part), 21),
                     # at one lane the two layouts are the same bytes: PyTorch
                     # launches nothing
                     "library_ms": graph_ms(lambda: part.t().contiguous()) if w > 1 else None,
                     "bound_ms": 1e3 * 2 * tsha.DH_ROWS * w / H100_BYTES_PER_S,
                     "launch_floor_ms": floor_ms}
    # as graph_ms launches it: captured once, replayed into the same output
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = sc.rows_to_cols(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got), "T1 replayed from a CUDA graph differs"
    del graph, replayed
    row = {
        "name": "dh_rows_to_cols",
        "route": "cuda",
        "source": "stellar_tpu_torch/csrc/sha512_h.cu",
        "replaces": None,
        "lanes": n,
        "mismatches": 0,
        "max_abs_err": 0,
        "ms": graph_ms(lambda: sc.rows_to_cols(x)),
        "call_ms": cuda_ms(lambda: sc.rows_to_cols(x), 21),
        "plain_ms": cuda_ms(lambda: tsha.cols_from_rows(x), 21),
        "bound_ms": 1e3 * 2 * tsha.DH_ROWS * n / H100_BYTES_PER_S,
        "bound_by": "bytes",
        "library_ms": graph_ms(lambda: x.t().contiguous()),
    }
    emit({"phase": "kernels", **row, "widths": widths, "launch_floor_ms": floor_ms})
    return row, got


def phase_kernel_sha512(chunk, rows, items, ok):
    """B2 on the first LANES lanes of T1's (160, n) chunk on the card, as
    the verify plane feeds it (``stage_rows``, the upload, T1)."""
    import torch

    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc

    p = chunk[:, :LANES].contiguous()
    rows, items, ok = rows[:LANES], items[:LANES], ok[:LANES]
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
    flags = rows[:, tsha.ROW_FLAG]
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
    """The bucket path's SHA-256 kernel launches, as (name, messages,
    max_blocks), each cut by ``hashplane.size_classes`` as the device
    backend cuts it:

    - ``flush_class2/4/8``: the three launches of the first 4 MB
      ``BucketHasher`` flush;
    - ``bucket_class2/4/8``: the three launches of ``hash_frames`` over the
      whole 10^6-record bucket (``bucket_class2`` was ``class_2_blocks``
      before, with the boundary messages among its lanes);
    - ``flush_4MB``: every frame of the first flush that fits in 4 blocks,
      plus the padding-boundary messages, in one ``max_blocks=4`` launch —
      a launch the node never makes, kept so that the figures compare with
      the earlier ones;
    - ``chain_k`` (k = 2, 4, 5): 32 frames of k blocks, one warp, in their
      class's shape: the time of one lane's serial chain."""
    import numpy as np

    from stellar_tpu_torch.bucket import hashplane as hp
    from stellar_tpu_torch.ops import sha256 as t256

    rng = random.Random(SEED + 2)
    boundary = [rng.randbytes(n) for n in SHA256_BOUNDARY]
    flush = int(np.searchsorted(np.cumsum(frame_len), hp._FLUSH_BYTES)) + 1
    nblocks = (frame_len + 8) // 64 + 1
    shapes = []
    for tag, nb in (("flush", nblocks[:flush]), ("bucket", nblocks)):
        for cap, idx in hp.size_classes(nb):
            shapes.append((f"{tag}_class{cap}", [frames[i] for i in idx], cap))
    fit4 = [frames[i] for i in np.flatnonzero(nblocks[:flush] <= 4)]
    shapes.append(("flush_4MB", fit4 + boundary, 4))
    for k in SHA256_CHAINS:
        idx = np.flatnonzero(nblocks == k)[:32]
        shapes.append((f"chain_{k}", [frames[i] for i in idx], 1 << (k - 1).bit_length()))
    return shapes


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


def sha256_row(c256, t256, name, msgs, max_blocks):
    """One SHA-256 kernel shape: the kernel of the wrapper's rule held
    against the plain version on the card (every lane) and hashlib (a
    sample, the boundary messages among it), then timed beside its bound."""
    import torch

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
    # the last lanes (flush_4MB's boundary messages) and a seeded sample
    check = set(range(max(0, n - len(SHA256_BOUNDARY)), n))
    check |= set(random.Random(SEED).sample(range(n), min(n, 1000)))
    for j in check:
        assert host[j].tobytes() == hashlib.sha256(msgs[j]).digest(), f"{name} lane {j}"
    ms = graph_ms(lambda: c256.digest_rows(p, nb))
    call_ms = cuda_ms(lambda: c256.digest_rows(p, nb), 11)
    plain_ms = cuda_ms(lambda: t256.sha256_rows_from_packed(p, nb), 2)
    blocks = int(counts.sum())
    ops_s = (blocks * SHA256_OPS_PER_BLOCK + n * SHA256_OPS_PER_LANE) / H100_IMAD_PER_S
    bytes_s = (64 * blocks + 36 * n) / H100_BYTES_PER_S
    row = {
        "shape": name, "kernel": c256.variant(n, max_blocks), "lanes": n, "max_blocks": max_blocks,
        "blocks": blocks, "pack_s": pack_s, "pack_loop_s": pack_loop_s, "mismatches": mismatches,
        "hashlib_checked": len(check), "max_abs_err": max_abs_err, "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": 1e3 * max(ops_s, bytes_s),
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
    }
    if name in SHA256_OLD_NAMES:
        row["earlier_name"] = SHA256_OLD_NAMES[name]
    return row


def phase_kernel_sha256(frames, frame_len):
    """Both SHA-256 kernels at the bucket path's launches (``sha256_shapes``);
    returns the kernels line's row of each: the lane kernel at
    ``bucket_class2``, the pair at ``flush_class4``."""
    from stellar_tpu_torch.ops import sha256 as t256
    from stellar_tpu_torch.ops import sha256_cuda as c256

    shapes = {}
    for name, msgs, max_blocks in sha256_shapes(frames, frame_len):
        shape = sha256_row(c256, t256, name, msgs, max_blocks)
        emit({"phase": "kernels", "name": "sha256_frames", **shape})
        shapes[name] = shape
    rows = []
    for kernel, main in (("lane", "bucket_class2"), ("pair", "flush_class4")):
        assert shapes[main]["kernel"] == kernel, (main, shapes[main]["kernel"])
        rows.append({
            "name": SHA256_KERNELS[kernel],
            "route": "cuda",
            "source": "stellar_tpu_torch/csrc/sha256_frames.cu",
            "replaces": "stellar_tpu/ops/sha256.py:183",
            "shape": main,
            **{k: shapes[main][k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            "library_ms": None,
        })
    return rows


# -- phase 4: the main path ---------------------------------------------------


class SpanSums:
    """A tracer (``span``/``begin``/``end``/``record``, ``enabled`` and on
    the real clock, as ``trace.tracer.Tracer``) that keeps the total
    seconds of each span name — the host-side breakdown of a load:
    staging (with the C stage's parts, which it ``record``s from its
    stamps), launch (enqueue only), and drain (the wait for the card)."""

    enabled = True
    real_clock = True

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._sums = {}

    def begin(self, name, **attrs):
        return (name, time.monotonic())

    def end(self, span, **attrs):
        if span is not None:
            name, t0 = span
            self.record(name, t0, time.monotonic())

    def record(self, name, start, end, **attrs):
        with self._lock:
            self._sums[name] = self._sums.get(name, 0.0) + (end - start)

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
    ec.launches = ec.signed_launches = ec.signed_pair_launches = sc.launches = 0
    sc.transpose_launches = 0
    ed.plain_calls = tsha.plain_calls = 0

    def counts():
        return {"ed25519_verify": ec.launches, "sha512_h": sc.launches,
                "dh_rows_to_cols": sc.transpose_launches}

    for name, caller, items, want, run in loads(backend):
        before = counts()
        t0 = time.perf_counter()
        got = run(backend, items, caller)
        sec = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts().items()}
        results.append((name, caller, items, want, got, sec, tracer.take_ms(), launched))
    launches = counts()
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
            # bytes) are multi-block, hashed by stage_rows: a flag-0-only load
            single_block = all(len(m) <= tsha.MAX_DEVICE_MSG for _, m, _ in items)
            assert (launched["sha512_h"] > 0) == single_block, (name, launched)
        # every device-hash chunk is staged item-major and transposed by T1
        # ahead of its B1, whether B2 runs or not
        t1 = launched["ed25519_verify"] if device_hash else 0
        assert launched["dh_rows_to_cols"] == t1, (name, launched)
    assert launches["ed25519_verify"] > 0, "the main path never launched the CUDA kernel"
    if device_hash:
        assert launches["sha512_h"] > 0, "the device-hash path never launched the SHA-512 kernel"
    else:
        assert launches["sha512_h"] == 0, "the host-hash path launched the SHA-512 kernel"
    assert plain_calls == {"ed25519": 0, "sha512": 0}, f"plain versions ran on the main path: {plain_calls}"
    assert ec.signed_launches == ec.signed_pair_launches == 0, \
        "the main path launched a signed kernel with the knob off"
    assert stats["device_hash"] is device_hash, stats["device_hash"]
    for key in ("cpu_cutover_items", "host_assist_items"):
        assert stats[key] == 0, f"{key} = {stats[key]}: items left the device"
    assert _stalls(stats) == 0, f"device stalls: {stats}"
    emit({
        "phase": phase, "launches": launches, "plain_calls": plain_calls,
        "libsodium_checked": fx.sodium, "stats": stats,
    })
    return backend, launches, per_load


def phase_torsion(fx, rng, backend, pks):
    """``torsion_check`` on TORSION_ENCS encodings on the card against
    ``ref25519.is_torsion_free``, and the host path on the same encodings
    against the card.  Returns the encodings and their verdicts."""
    from stellar_tpu_torch.crypto.sigbackend import CpuSigBackend
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
    assert _stalls(backend.stats()) == 0, backend.stats()
    # the host path (native/halfagg.c's ladder): what the cpu backend and a
    # torsion batch below the cutover run instead of the card
    t0 = time.perf_counter()
    host = CpuSigBackend().torsion_check(encs)
    host_sec = time.perf_counter() - t0
    assert host == got, f"torsion: the host path differs from the card on {sum(h != g for h, g in zip(host, got))} encodings"
    emit({
        "phase": "torsion", "encodings": len(encs), "torsion_free": sum(want),
        "launches": launches, "ms": sec * 1e3, "host_path_equal": True, "host_ms": host_sec * 1e3,
    })
    return encs, want


# -- phase 5b: the port's bench ----------------------------------------------


class LaunchTap:
    """While installed, the first launch of each kernel under each key
    (``key()``, read at the launch: a bench stage, an entry point's path)
    keeps its input and output (clones on the launch's stream), to be held
    against the plain versions afterwards: B1, the signed windows' two
    kernels, T1 and B2.  The B1 wrapper's calls are made one at a time (their
    host side only: the kernels still run on their streams), so the launch
    count a call moves by one names the kernel it launched.  Install the
    tap before the verifiers are built: a verifier binds the B1 wrapper
    when built."""

    def __init__(self, key):
        import threading

        from stellar_tpu_torch.ops import ed25519, ed25519_cuda, sha512_cuda

        self.key = key
        self.ed, self.ec, self.sc = ed25519, ed25519_cuda, sha512_cuda
        self.verify, self.hash = ed25519_cuda.verify_packed, sha512_cuda.hash_in_place
        self.transpose = sha512_cuda.rows_to_cols
        self.lock, self.call_lock = threading.Lock(), threading.Lock()
        self.b1, self.b2, self.t1 = {}, {}, {}

    def _counts(self):
        return {"ed25519_verify": self.ec.launches, "ed25519_verify_signed": self.ec.signed_launches,
                "ed25519_verify_signed_pair": self.ec.signed_pair_launches}

    def _first(self, kept, key):
        with self.lock:
            if key in kept:
                return False
            kept[key] = None
            return True

    def __enter__(self):
        def verify(p, signed=None, variant=None):
            with self.call_lock:
                before = self._counts()
                out = self.verify(p, signed=signed, variant=variant)
                moved = {k: n - before[k] for k, n in self._counts().items() if n != before[k]}
            # one count up by one: this call's launch (a verifier built
            # before the tap, launching meanwhile, would move another)
            if p.is_cuda and list(moved.values()) == [1]:
                (name,) = moved
                key = (self.key(), name)
                if self._first(self.b1, key):
                    self.b1[key] = (p.clone(), out.clone(), name != "ed25519_verify")
            return out

        def hash_in_place(p):
            key = (self.key(), "sha512_h")
            keep = p.is_cuda and self._first(self.b2, key)
            before = p.clone() if keep else None
            self.hash(p)
            if keep:
                self.b2[key] = (before, p.clone())

        def rows_to_cols(x):
            out = self.transpose(x)
            if x.is_cuda and self._first(self.t1, (self.key(), "dh_rows_to_cols")):
                self.t1[(self.key(), "dh_rows_to_cols")] = (x.clone(), out.clone())
            return out

        self.ec.verify_packed, self.sc.hash_in_place = verify, hash_in_place
        self.sc.rows_to_cols = rows_to_cols
        return self

    def __exit__(self, *exc):
        self.ec.verify_packed, self.sc.hash_in_place = self.verify, self.hash
        self.sc.rows_to_cols = self.transpose

    def check(self):
        """{key: {kernel: lanes, mismatches}} against the plain versions,
        each launch's whole chunk in one plain call on the card."""
        import torch

        from stellar_tpu_torch.ops import sha512 as tsha

        torch.cuda.synchronize()
        out = {}
        for (key, name), (p, got, signed) in self.b1.items():
            plain = self.ed._verify_packed(p, signed=signed)
            out.setdefault(key, {})[name] = {
                "lanes": int(p.shape[1]), "accepts": int(got.sum()),
                "mismatches": int((plain != got).sum())}
        for (key, name), (before, after) in self.b2.items():
            plain = tsha.h_rows_from_packed(before).to(torch.uint8)
            moved = int((after[:96] != before[:96]).any(dim=0).sum()
                        + (after[128:] != before[128:]).any(dim=0).sum())
            out.setdefault(key, {})[name] = {
                "lanes": int(before.shape[1]),
                "mismatches": int((after[96:128] != plain).any(dim=0).sum()) + moved}
        for (key, name), (x, got) in self.t1.items():
            out.setdefault(key, {})[name] = {
                "lanes": int(x.shape[0]),
                "mismatches": int((got != tsha.cols_from_rows(x)).any(dim=0).sum())}
        torch.cuda.synchronize()
        return out


def phase_bench():
    """``bench``: the port's bench's ``main()`` at full width, in process;
    returns its launches of B1, B2 and T1."""
    import contextlib
    import io

    from stellar_tpu_torch import bench

    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in BENCH_KNOBS}
    os.environ.update(BENCH_KNOBS)
    stdout = io.StringIO()
    try:
        with LaunchTap(lambda: bench._progress.get("stage")) as tap:
            _node_counts(reset=True)
            try:
                with contextlib.redirect_stdout(stdout):
                    bench.main()
            except SystemExit as e:
                raise AssertionError(f"the bench exited {e.code}: {stdout.getvalue()}") from None
            counts = _node_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = [ln for ln in stdout.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, f"the bench printed {len(lines)} lines: {lines}"
    line = json.loads(lines[0])
    bench_s = time.perf_counter() - t0
    vs_plain = tap.check()
    emit({"phase": "bench", "line": line, "byzantine_flood": bench._progress.get("byzantine_flood"),
          "launches": counts["launches"],
          "plain_calls": counts["plain_calls"], "first_launch_vs_plain": vs_plain,
          "seconds": bench_s, "check_seconds": time.perf_counter() - t0 - bench_s})
    errors = {k: v for k, v in line.items() if k == "error" or k.endswith("_error")}
    assert not errors, f"the bench reported errors: {errors}"
    assert line["value"] > 0, "the bench measured no headline rate"
    assert line["batch"] == int(BENCH_KNOBS["BENCH_BATCH"]), line["batch"]
    assert all(v == 0 for v in counts["plain_calls"].values()), counts["plain_calls"]
    missing = [s for s in BENCH_B1_STAGES if s not in vs_plain]
    assert not missing, f"bench legs that never launched B1: {missing}"
    assert "sha512_h" in vs_plain["verify-device-hash"], "the device-hash leg never launched B2"
    assert "dh_rows_to_cols" in vs_plain["verify-device-hash"], "the device-hash leg never launched T1"
    bad = {s: k for s, ks in vs_plain.items() for k, r in ks.items() if r["mismatches"]}
    assert not bad, f"bench launches that disagree with the plain version: {bad}"
    launched = counts["launches"]
    assert launched["ed25519_verify_signed"] == launched["ed25519_verify_signed_pair"] == 0
    return {k: launched[k] for k in ("ed25519_verify", "sha512_h", "dh_rows_to_cols")}


# -- phase 5c: the port's close and state profilers --------------------------


class ProfilerTap:
    """While installed, the first B1 launch (and the widest,
    ``ed25519_verify_widest``) and the first launch of each B3 kernel
    (lane, pair) of each profiler path (``path``, set by the phase) keep
    their input and output, to be held against the plain versions
    afterwards, and every node stopped meanwhile leaves its last ledger
    hash and its verify backend's stats.  Install it before the nodes are
    built: a verifier binds the B1 wrapper when built."""

    def __init__(self):
        import threading

        from stellar_tpu_torch.main.application import Application
        from stellar_tpu_torch.ops import ed25519_cuda, sha256_cuda

        self.app_cls, self.ec, self.c256 = Application, ed25519_cuda, sha256_cuda
        self.verify, self.digest = ed25519_cuda.verify_packed, sha256_cuda.digest_rows
        self.stop = Application.graceful_stop
        self.lock = threading.Lock()
        self.path = None
        self.kept = {}
        self.apps = {}

    def _first(self, name):
        with self.lock:
            if (self.path, name) in self.kept:
                return False
            self.kept[(self.path, name)] = None
            return True

    def __enter__(self):
        def verify(p, *args, **kwargs):
            out = self.verify(p, *args, **kwargs)
            if p.is_cuda and self._first("ed25519_verify"):
                self.kept[(self.path, "ed25519_verify")] = (p.clone(), out.clone())
            widest = (self.path, "ed25519_verify_widest")
            with self.lock:
                prev = self.kept.get(widest)
                if p.is_cuda and (prev is None or p.shape[1] > prev[0].shape[1]):
                    self.kept[widest] = (p.clone(), out.clone())
            return out

        def digest_rows(p, nblocks):
            out = self.digest(p, nblocks)
            name = SHA256_KERNELS[self.c256.variant(int(p.shape[1]), int(p.shape[0]) // 64)]
            if p.is_cuda and self._first(name):
                self.kept[(self.path, name)] = (p.clone(), nblocks.clone(), out.clone())
            return out

        def graceful_stop(app):
            with self.lock:
                self.apps.setdefault(self.path, []).append(
                    (app.ledger_manager.last_closed.hash.hex(), app.sig_backend.stats()))
            return self.stop(app)

        self.ec.verify_packed, self.c256.digest_rows = verify, digest_rows
        self.app_cls.graceful_stop = graceful_stop
        return self

    def __exit__(self, *exc):
        self.ec.verify_packed, self.c256.digest_rows = self.verify, self.digest
        self.app_cls.graceful_stop = self.stop

    def check(self):
        """{path: {kernel: lanes, mismatches}}: each kept launch's whole
        input in one plain call on the card."""
        import torch

        from stellar_tpu_torch.ops import ed25519 as ed
        from stellar_tpu_torch.ops import sha256 as t256

        torch.cuda.synchronize()
        out = {}
        for (path, name), kept in self.kept.items():
            if name.startswith("ed25519_verify"):
                p, got = kept
                row = {"lanes": int(p.shape[1]), "accepts": int(got.sum()),
                       "mismatches": int((ed._verify_packed(p) != got).sum())}
            else:
                p, nb, got = kept
                plain = t256.sha256_rows_from_packed(p, nb).to(torch.uint8)
                row = {"lanes": int(p.shape[1]), "max_blocks": int(p.shape[0]) // 64,
                       "mismatches": int((plain != got).any(dim=0).sum())}
            out.setdefault(path, {})[name] = row
        torch.cuda.synchronize()
        return out


def _profiler_run(tap, path, fn):
    """One profiler call on ``path``: the launch counts set to 0 just before
    and read just after, what it printed, its result and seconds."""
    import contextlib
    import io

    tap.path = path
    _node_counts(reset=True)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result = fn()
    seconds = time.perf_counter() - t0
    counts = _node_counts()
    stats = [st for _, st in tap.apps.get(path, [])]
    line = {"phase": "profilers", "path": path, "seconds": seconds,
            "printed": printed.getvalue().splitlines(), **counts,
            "stalls": sum(_stalls(st) for st in stats),
            "node_hashes": [h for h, _ in tap.apps.get(path, [])]}
    assert counts["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, counts
    assert line["stalls"] == 0, f"{path}: a dispatch stalled"
    return result, line


def phase_profilers():
    """``profilers``: the port's close and state profilers on the card at
    full width, in process, through the functions their CLIs call:
    ``profile_close.pipeline_report(5000, 3)`` (the paired close-pipeline
    report: PARANOID, invariants all-on, hashes, SQL dumps and history metas
    bit-exact between its legs), ``profile_system._rung(10**6)`` (the state
    ladder's top rung: 12 traffic closes, the spill merge, the catchup
    re-hash and the three bucket backends hash for hash, the device leg over
    every bucket) and ``profile_system.hash_ab(64)`` (its 2x gate printed as
    ``gate_ok``, a speed verdict that fails nothing).  The launch counts are
    set to 0 just before each call and read just after; the first and the
    widest B1 launch and the first launch of each B3 kernel of each call
    are held against the plain versions on the card afterwards.  Fails on any exception, a
    hash or bit-identity mismatch, an invariant violation (the report's own
    assertions), a stall, a plain call or a zero launch count.  Returns the
    launches by path."""
    from stellar_tpu_torch import harness
    from stellar_tpu_torch import profile_close as pc
    from stellar_tpu_torch import profile_system as ps

    t_phase = time.perf_counter()
    os.environ.pop("PROFILE_DEVICE", None)
    launches = {}
    try:
        with ProfilerTap() as tap:
            rc, line = _profiler_run(tap, "profile_close", lambda: pc.pipeline_report(
                PIPELINE_TXS, PIPELINE_LEDGERS))
            text = "\n".join(line["printed"])
            m = re.search(r"pipeline: dispatched (\d+), joined (\d+)", text)
            line.update(call=f"pipeline_report({PIPELINE_TXS}, {PIPELINE_LEDGERS})",
                        acceptance_rc=rc, dispatched=int(m.group(1)) if m else None,
                        joined=int(m.group(2)) if m else None)
            emit(line)
            assert "final ledger hashes + SQL dumps + history metas bit-exact" in text, text
            assert len(set(line["node_hashes"])) == 1 and len(line["node_hashes"]) == 2
            assert line["dispatched"] == line["joined"] == PIPELINE_LEDGERS - 1, line
            launches["profile_close"] = line["launches"]

            rung, line = _profiler_run(tap, "state_ladder", lambda: ps._rung(LADDER_ACCOUNTS))
            line.update(call=f"_rung({LADDER_ACCOUNTS})", rung=rung)
            emit(line)
            ab = rung["backends"]
            assert ab["bit_identical"] and "mismatch" not in ab, ab
            assert ab["device_backend"] == "device-cuda", ab
            assert ab["device_buckets_covered"] == rung["n_buckets"] >= 2, rung
            launches["state_ladder"] = line["launches"]

            rc, line = _profiler_run(tap, "hash_ab", lambda: ps.hash_ab(HASH_AB_MB))
            m = re.search(r"host\[(\w+)\] ([\d,.]+) MB/s; device\[([\w-]+)\] ([\d,.]+) MB/s;"
                          r" ratio ([\d.]+)x", "\n".join(line["printed"]))
            assert m, line["printed"]
            line.update(call=f"hash_ab({HASH_AB_MB})", gate_ok=rc == 0, host=m.group(1),
                        host_mb_per_s=float(m.group(2).replace(",", "")), device=m.group(3),
                        device_mb_per_s=float(m.group(4).replace(",", "")),
                        ratio=float(m.group(5)))
            emit(line)
            assert line["device"] == "device-cuda", line
            launches["hash_ab"] = line["launches"]
        t_check = time.perf_counter()
        vs_plain = tap.check()
    finally:
        harness.close_pool()
    emit({"phase": "profilers", "first_launch_vs_plain": vs_plain,
          "seconds": time.perf_counter() - t_phase, "check_seconds": time.perf_counter() - t_check})
    for path in ("profile_close", "state_ladder"):
        assert launches[path]["ed25519_verify"] > 0, (path, launches[path])
        assert "ed25519_verify" in vs_plain[path], (path, vs_plain)
    for path in ("state_ladder", "hash_ab"):
        assert launches[path]["sha256_frames"] > 0, (path, launches[path])
        assert set(vs_plain[path]) & set(SHA256_KERNELS.values()), (path, vs_plain)
    assert all(n[k] == 0 for n in launches.values()
               for k in ("ed25519_verify_signed", "ed25519_verify_signed_pair", "sha512_h")), launches
    bad = {p: k for p, ks in vs_plain.items() for k, r in ks.items() if r["mismatches"]}
    assert not bad, f"profiler launches that disagree with the plain version: {bad}"
    return launches


# -- phase 5d: the port's kernel profiler and driver entry ------------------


def phase_profile_kernel():
    """``profile_kernel``: the port's kernel profiler and driver entry
    (``python -m stellar_tpu_torch.profile_kernel`` / ``graft_entry``) on
    the card, in process, through the functions their CLIs call:
    ``graft_entry.entry()`` (verdicts equal to the mask) and
    ``dryrun_multichip(2)`` (distinct cards where there are two, else the
    repeated-device rig); ``profile_kernel.main(32768, ab=True)`` (B1, the
    wide B1s, B1); ``device_hash_ab(8192, 3)`` and ``mesh_curve([1, 2, 4],
    2048, 3)`` on the rig, each into a temporary file — their gates' rc a
    field, a speed verdict that fails nothing.  The launch counts are set to
    0 just before each call and read just after, ``entry()`` and the dryrun
    apart (the curve's legs are child processes: each counts its launches
    and plain calls by kernel and prints them); the first launch of each
    kernel on each in-process path is held against the plain version on the
    card afterwards, the legs' launches against the oracle (their mixed
    lanes exact, their timed lanes all valid).  Fails on any exception, a
    wrong verdict, an oracle or mesh leg that failed, a plain call (a
    leg's too), a mismatch or a zero launch count.  Returns the launches
    by path."""
    import contextlib
    import io

    from stellar_tpu_torch import graft_entry as ge
    from stellar_tpu_torch import harness
    from stellar_tpu_torch import profile_kernel as pk

    t_phase = time.perf_counter()
    os.environ.pop("PROFILE_DEVICE", None)
    path = [None]
    launches = {}

    def run(name, call, fn):
        path[0] = name
        _node_counts(reset=True)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = fn()
        counts = _node_counts()
        assert counts["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, (name, counts)
        launches[name] = counts["launches"]
        return result, {"phase": "profile_kernel", "path": name, "call": call,
                        "seconds": time.perf_counter() - t0,
                        "printed": printed.getvalue().splitlines(), **counts}

    def entry():
        fn, args = ge.entry()
        return fn(*args).cpu().numpy()

    try:
        with LaunchTap(lambda: path[0]) as tap, \
                tempfile.TemporaryDirectory(prefix="chip_smoke_profile_kernel_") as tmp:
            want = ge._mixed_lane_items(16)[1]
            got, line = run("graft_entry", "entry()", entry)
            line.update(verdicts=got.tolist(), mask=want.tolist())
            emit(line)
            assert (got == want).all(), "entry(): verdicts differ from the mask"

            _, line = run("graft_entry_dryrun", f"dryrun_multichip({DRYRUN_SHARDS})",
                          lambda: ge.dryrun_multichip(DRYRUN_SHARDS))
            emit(line)
            assert line["printed"][-1].startswith(
                f"dryrun_multichip OK: 256 lanes over {DRYRUN_SHARDS} devices"), line["printed"]

            out, line = run("profile_kernel", f"main({KERNEL_PROFILE_LANES}, ab=True)",
                            lambda: pk.main(KERNEL_PROFILE_LANES, ab=True))
            line.update(result=out)
            emit(line)
            assert [leg["kernel"] for leg in out["legs"]] == ["unsigned", "wide", "unsigned"], out

            dh_path = os.path.join(tmp, "DEVICE_HASH_torch.json")
            rc, line = run("device_hash_ab",
                           f"device_hash_ab({DEVICE_HASH_AB_LANES}, {DEVICE_HASH_AB_REPS})",
                           lambda: pk.device_hash_ab(DEVICE_HASH_AB_LANES, DEVICE_HASH_AB_REPS,
                                                     dh_path))
            with open(dh_path) as f:
                record = json.load(f)
            line.update(gate_rc=rc, record=record)
            del line["printed"]
            emit(line)
            assert record["mixed_oracle_exact_both_layouts"] and record["kernel_backend"] == "cuda"
            assert record["gated"] and rc == (0 if record["ok"] else 1), record

            mc_path = os.path.join(tmp, "MULTICHIP_torch.json")
            rc, line = run("mesh_curve", f"mesh_curve({list(MESH_CURVE_COUNTS)}, "
                           f"{MESH_CURVE_PER_CHIP}, {MESH_CURVE_REPS})",
                           lambda: pk.mesh_curve(list(MESH_CURVE_COUNTS), MESH_CURVE_PER_CHIP,
                                                 MESH_CURVE_REPS, False, mc_path))
            with open(mc_path) as f:
                record = json.load(f)
            line.update(gate_rc=rc, record=record)
            del line["printed"]
            emit(line)
            assert not record["failures"] and not record["skipped_legs"], record["failures"]
            for leg in record["legs"]:
                assert leg["mixed_oracle_exact"] and leg["kernel_backend"] == "cuda", leg
                assert leg["plain_calls"] == {"ed25519": 0, "sha512": 0}, leg
                assert leg["launches"]["ed25519_verify"] > 0 and leg["device_calls"] > 0, leg
            assert rc == (0 if record["ok"] else 1), record
            # each kernel's count on its own row; the children's launches
            # are held against the oracle (their mixed lanes exact, their
            # timed lanes all valid), not the plain version
            launches["mesh_curve"] = {k: sum(leg["launches"][k] for leg in record["legs"])
                                      for k in record["legs"][0]["launches"]}
        t_check = time.perf_counter()
        vs_plain = tap.check()
    finally:
        harness.close_pool()
    emit({"phase": "profile_kernel", "first_launch_vs_plain": vs_plain,
          "seconds": time.perf_counter() - t_phase, "check_seconds": time.perf_counter() - t_check})
    expect = {"graft_entry": ("ed25519_verify",), "graft_entry_dryrun": ("ed25519_verify",),
              "profile_kernel": ("ed25519_verify", "ed25519_verify_signed"),
              "device_hash_ab": ("ed25519_verify", "sha512_h", "dh_rows_to_cols")}
    for name, kernels in expect.items():
        for k in kernels:
            assert launches[name][k] > 0 and k in vs_plain[name], (name, k, launches[name], vs_plain)
    bad = {p: k for p, ks in vs_plain.items() for k, r in ks.items() if r["mismatches"]}
    assert not bad, f"entry-point launches that disagree with the plain version: {bad}"
    return launches


# -- phase 7: the sharded verify path ----------------------------------------


def hostile_items(item):
    """Lanes built from one signed triple that the strict gate refuses (s
    >= L, a small-order A, short fields) or that fail the curve check (a
    wrong message, a corrupted R)."""
    from stellar_tpu_torch.ops import ref25519 as ref

    pk, msg, sig = item
    bad_r = bytes([sig[0] ^ 0x10]) + sig[1:]
    return [
        (pk, msg, sig[:32] + ref.L.to_bytes(32, "little")),
        (pk, msg, sig[:32] + (ref.L + 7).to_bytes(32, "little")),
        (pk, msg, sig[:32] + (2**256 - 1).to_bytes(32, "little")),
        (bytes(32), msg, sig),
        (pk[:31], msg, sig),
        (pk, msg, sig[:63]),
        (pk, msg + b"!", sig),
        (pk, msg, bad_r),
    ]


def verify_calls_vs_plain(calls):
    """The plain version over kept (input chunk, verdicts) pairs of verify
    kernel launches, in LANES-lane calls on the card: launches, lanes,
    accepts, mismatches and seconds."""
    import torch

    from stellar_tpu_torch.ops import ed25519 as ed

    torch.cuda.synchronize()
    card = calls[0][0].device  # launches on other cards are checked on the first's
    packed = torch.cat([p.to(card) for p, _ in calls], dim=1)
    kernel = torch.cat([v.to(card) for _, v in calls])
    t0 = time.perf_counter()
    plain = torch.cat([ed._verify_packed(packed[:, i:i + LANES].contiguous())
                       for i in range(0, packed.shape[1], LANES)])
    torch.cuda.synchronize()
    return {"launches": len(calls), "lanes": int(packed.shape[1]),
            "accepts": int(kernel.sum()), "mismatches": int((kernel != plain).sum()),
            "plain_s": time.perf_counter() - t0}


class ShardTap:
    """Keeps every launch of one verifier's kernels while ``recording``:
    B1's input chunk and verdicts (wrapping the verifier's bound wrapper,
    so its launch count stays the wrapper's own) and, for every verifier at
    once, T1's item-major rows and chunk, and B2's chunk before and h rows
    after its in-place launch.  ``check`` holds them all against the plain
    versions on the card."""

    def __init__(self):
        from stellar_tpu_torch.ops import sha512_cuda

        self.mod = sha512_cuda
        self.hash_in_place = sha512_cuda.hash_in_place
        self.rows_to_cols = sha512_cuda.rows_to_cols
        self.b1, self.b2, self.t1 = [], [], []
        self.recording = False

    def wrap(self, bv):
        real = bv._verify_packed

        def tapped(p):
            out = real(p)
            if self.recording:
                self.b1.append((p.clone(), out.clone()))
            return out

        bv._verify_packed = tapped
        return real

    def __enter__(self):
        def tapped(p):
            before = p.clone() if self.recording else None
            self.hash_in_place(p)
            if before is not None:
                self.b2.append((before, p[96:128].clone()))

        def transposed(x):
            out = self.rows_to_cols(x)
            if self.recording:
                self.t1.append((x.clone(), out.clone()))
            return out

        self.mod.hash_in_place, self.mod.rows_to_cols = tapped, transposed
        return self

    def __exit__(self, *exc):
        self.mod.hash_in_place, self.mod.rows_to_cols = self.hash_in_place, self.rows_to_cols

    def check(self):
        import torch

        from stellar_tpu_torch.ops import sha512 as tsha

        b1 = verify_calls_vs_plain(self.b1)
        card = self.b2[0][0].device
        before = torch.cat([p.to(card) for p, _ in self.b2], dim=1)
        h = torch.cat([r.to(card) for _, r in self.b2], dim=1)
        want = torch.cat([tsha.h_rows_from_packed(before[:, i:i + LANES]).to(torch.uint8)
                          for i in range(0, before.shape[1], LANES)], dim=1)
        t1 = [int((out != tsha.cols_from_rows(x)).any(dim=0).sum()) for x, out in self.t1]
        return {"ed25519_verify": b1, "sha512_h": {
            "launches": len(self.b2), "lanes": int(before.shape[1]),
            "mismatches": int((h != want).any(dim=0).sum())}, "dh_rows_to_cols": {
            "launches": len(self.t1), "lanes": sum(int(x.shape[0]) for x, _ in self.t1),
            "mismatches": sum(t1)}}


def _expected_shards(bv, n):
    """(live shards, dead shards) of an n-item load through ``bv``: its
    chunks of max_batch lanes, each cut as ``_shard_ranges`` cuts it."""
    live = dead = 0
    for s in range(0, n, bv.max_batch):
        ranges = bv._shard_ranges(min(bv.max_batch, n - s))
        live += len(ranges)
        dead += len(bv.mesh) - len(ranges)
    return live, dead


def mesh_loads(fx, ledger, scp, torsion):
    """The mesh phase's loads: (name, kind, items, verdicts, single-block)."""
    rem = ledger[0][:MESH_REMAINDER]
    rem_items = list(rem[: MESH_REMAINDER - 8])
    for j, h in enumerate(hostile_items(ledger[0][0])):
        rem_items.insert(4 * j + 1, h)
    rem_want = fx.ref_verify(rem_items)
    assert any(rem_want) and not all(rem_want)
    return [
        ("ledger_5000tx", "verify", *ledger, True),
        ("scp_300", "verify", *scp, False),
        (f"remainder_{MESH_REMAINDER}", "verify", rem_items, rem_want, True),
        (f"torsion_{TORSION_ENCS}", "torsion", *torsion, False),
    ]


def phase_mesh(fx, tmp, ledger, scp, torsion):
    """``mesh``: the sharded verify path on the card (module docstring).
    Returns the sharded verifiers' B1, B2 and T1 launches."""
    import torch

    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc
    from stellar_tpu_torch.parallel import mesh as pm

    n_cards = torch.cuda.device_count()
    line = {"phase": "mesh", "device_count": n_cards}
    if n_cards == 1:
        assert pm.mesh_from_spec("auto") is None, "auto made a mesh on one card"
        from stellar_tpu_torch.main.application import Application
        from stellar_tpu_torch.util.clock import REAL_TIME, VirtualClock

        try:
            Application.create(VirtualClock(REAL_TIME), node_config(tmp, "mesh_refused", "cuda",
                                                                    SIG_MESH=2), new_db=True)
        except ValueError as e:
            assert "addressable" in str(e), e
            line["sig_mesh_2_refused"] = str(e)
        else:
            raise AssertionError("SIG_MESH = 2 booted on one card")
    card = torch.device("cuda", 0)
    meshes = {f"cuda0x{k}": [card] * k for k in MESH_SHARDS}
    if n_cards >= 2:
        meshes["cuda0_cuda1"] = [card, torch.device("cuda", 1)]
    if n_cards > 2:
        meshes[f"cards_x{n_cards}"] = pm.local_devices()
    if n_cards == 1:
        line["multi_card"] = "not run: 1 card"
    emit(line)
    loads = mesh_loads(fx, ledger, scp, torsion)
    launched = {"ed25519_verify": 0, "sha512_h": 0, "dh_rows_to_cols": 0}
    with ShardTap() as tap:
        for device_hash in (False, True):
            verifiers = {"unsharded": ed.BatchVerifier(max_batch=LANES, device="cuda",
                                                       device_hash=device_hash,
                                                       tracer=SpanSums())}
            for name, devs in meshes.items():
                verifiers[name] = pm.make_sharded_verifier(
                    mesh=pm.make_mesh(devs), max_batch=LANES, device_hash=device_hash,
                    tracer=SpanSums())
            bound = {name: tap.wrap(bv) for name, bv in verifiers.items() if name != "unsharded"}
            for load, kind, items, want, single_block in loads:
                run = {}
                for name, bv in verifiers.items():
                    fn = bv.verify if kind == "verify" else bv.verify_torsion
                    sharded = name != "unsharded"
                    ec.launches = sc.launches = sc.transpose_launches = 0
                    ed.plain_calls = tsha.plain_calls = 0
                    tap.recording = sharded
                    got = fn(items)
                    tap.recording = False
                    counts = {"ed25519_verify": ec.launches, "sha512_h": sc.launches,
                              "dh_rows_to_cols": sc.transpose_launches}
                    assert ed.plain_calls == tsha.plain_calls == 0, (name, load)
                    assert got == want, (
                        f"mesh {name} {load}: {sum(g != w for g, w in zip(got, want))} "
                        "verdicts differ from the known ones")
                    run[name] = {"launches": counts}
                    if sharded:
                        live, dead = _expected_shards(bv, len(items))
                        b2 = live if device_hash and single_block else 0
                        # each live shard of a device-hash verify chunk is
                        # transposed on its own; torsion stages no rows
                        t1 = live if device_hash and kind == "verify" else 0
                        assert counts == {"ed25519_verify": live, "sha512_h": b2,
                                          "dh_rows_to_cols": t1}, (name, load, counts, live)
                        run[name].update(live_shards=live, dead_shards=dead)
                        for key in launched:
                            launched[key] += counts[key]
                # the unsharded verifier's verdicts in this call: the known ones
                # too, so sharded == unsharded; now the timed calls, in turns
                # (the tap's wrappers taken off the sharded verifiers)
                for name, real in bound.items():
                    verifiers[name]._verify_packed = real
                times = {name: [] for name in verifiers}
                for bv in verifiers.values():
                    bv._tracer.take_ms()
                for _ in range(MESH_REPS):
                    for name, bv in verifiers.items():
                        fn = bv.verify if kind == "verify" else bv.verify_torsion
                        t0 = time.perf_counter()
                        fn(items)
                        times[name].append((time.perf_counter() - t0) * 1e3)
                for name in bound:
                    tap.wrap(verifiers[name])
                emit({"phase": "mesh", "load": load, "items": len(items),
                      "device_hash": device_hash, "verdicts_equal_unsharded": True,
                      "ms": {name: statistics.median(t) for name, t in times.items()},
                      "ms_all": times,
                      "span_ms": {name: {k: v / MESH_REPS for k, v in bv._tracer.take_ms().items()}
                                  for name, bv in verifiers.items()},
                      "shards": {name: r for name, r in run.items()}})
            for bv in verifiers.values():
                assert bv.stats()["mesh_devices"] == (len(bv.mesh) if bv.mesh is not None else 0)
        verdicts = tap.check()
    emit({"phase": "mesh", "verdicts_vs_plain": verdicts, "launches": launched})
    for name, v in verdicts.items():
        assert v["launches"] == launched[name] > 0 and v["mismatches"] == 0, verdicts
    return launched


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
    the no-native environment variable).  Returns the SHA-256 kernels'
    launches on the device backend (``hash_frames`` and ``BucketHasher``),
    by kernel."""
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
        c256.launches = c256.lane_launches = c256.pair_launches = 0
        t256.plain_calls = 0
        t0 = time.perf_counter()
        whole = hp.hash_frames(buf, cfg)
        whole_s = time.perf_counter() - t0
        whole_launches = {"lane": c256.lane_launches, "pair": c256.pair_launches}
        whole_spans = spans.take_ms()
        t0 = time.perf_counter()
        hasher = hp.BucketHasher(cfg)
        for fr in frames:
            hasher.add(fr)
        streamed = (hasher.finish(), hasher.count)
        streamed_s = time.perf_counter() - t0
        launches = {"lane": c256.lane_launches, "pair": c256.pair_launches}
        plain_calls = t256.plain_calls
        streamed_launches = {k: launches[k] - whole_launches[k] for k in launches}
        line = {
            "phase": "bucket_hash", "backend": backend.name, "records": whole[1],
            "mb": mb, "hash": whole[0].hex(),
            "hash_frames_s": whole_s, "hash_frames_mb_per_s": mb / whole_s,
            "bucket_hasher_s": streamed_s, "bucket_hasher_mb_per_s": mb / streamed_s,
            "launches": {"hash_frames": whole_launches, "bucket_hasher": streamed_launches},
            "plain_calls": plain_calls,
        }
        if knob:
            assert sum(launches.values()) == c256.launches, (launches, c256.launches)
            # the whole bucket's widest class runs the lane kernel, every
            # flush's narrow classes the pair
            assert all(whole_launches.values()) and all(streamed_launches.values()), line["launches"]
            assert plain_calls == 0, f"the plain SHA-256 ran {plain_calls} times"
            line["span_ms"] = {"hash_frames": whole_spans, "bucket_hasher": spans.take_ms()}
            device_launches = launches
        emit(line)
        hashes[name] = (whole, streamed)
    os.environ.pop("STELLAR_TPU_NO_NATIVE_HASH", None)
    hp.reset_backend_cache()
    results = {r for pair in hashes.values() for r in pair}
    assert len(results) == 1 and next(iter(results))[1] == BUCKET_RECORDS, hashes
    return device_launches


# -- phases 9-10: the validator node ----------------------------------------


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
        ec.launches = ec.signed_launches = ec.signed_pair_launches = sc.launches = 0
        sc.transpose_launches = 0
        c256.launches = c256.lane_launches = c256.pair_launches = 0
        ed.plain_calls = tsha.plain_calls = t256.plain_calls = 0
        keys.reset_stats()
        keys.PubKeyUtils.clear_verify_sig_cache()
        return None
    return {
        "launches": {"ed25519_verify": ec.launches, "ed25519_verify_signed": ec.signed_launches,
                     "ed25519_verify_signed_pair": ec.signed_pair_launches,
                     "sha512_h": sc.launches, "dh_rows_to_cols": sc.transpose_launches,
                     "sha256_frames": c256.launches,
                     "sha256_frames_lane": c256.lane_launches,
                     "sha256_frames_pair": c256.pair_launches},
        "plain_calls": {"ed25519": ed.plain_calls, "sha512": tsha.plain_calls,
                        "sha256": t256.plain_calls},
        "eager_ref_verifies": keys.stats()["eager_ref_verifies"],
    }


def _stalls(stats):
    """Items of dispatches that outlived their budget or that the card
    never answered, plus latch flips: any of them fails the phase (the
    card's runs hide no stall)."""
    return (stats["stalled_items"] + stats["stall_rejected_items"]
            + sum(stats["wedge_latch_flips"].values()))


def node_close_leg(load, tmp, leg, device, device_hash, untimed_close, rounds=NODE_ROUNDS,
                   **knobs):
    """``close_leg`` under a width-only ``VerifyTap``: its line gains the
    leg's ``launch_widths``."""
    with VerifyTap(keep=False) as tap:
        line = close_leg(load, tmp, leg, device, device_hash, untimed_close, rounds, **knobs)
    line["launch_widths"] = tap.launch_widths()
    emit(line)
    return line


def close_leg(load, tmp, leg, device, device_hash, untimed_close, rounds, **knobs):
    """One standalone validator: the account ledgers, ``rounds`` timed
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
                      DESIRED_MAX_TX_PER_LEDGER=2 * NODE_TXS, INVARIANT_SAMPLED=True, **knobs)
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
        frames = [load.frames(envs) for envs in load.rounds]
        times = []
        for r in range(rounds):
            ts, ok, t0 = check(frames[r])
            if device == "cuda" and r + 1 < rounds + untimed_close:
                app.close_pipeline.note_upcoming(frames[r + 1])
            commit(ts)
            times.append(time.perf_counter() - t0)
            assert ok == (r != NODE_BAD_ROUND), f"{leg}: payment round {r}'s txset check: {ok}"
        bad_tx = frames[NODE_BAD_ROUND][NODE_BAD_INDEX].get_result_code().name
        spans = {name: agg["p50_ms"] for name, agg in app.tracer.aggregates().items()
                 if name.startswith(("close.", "sig.", "ledger.", "txset."))}
        if untimed_close:
            ts, ok, _ = check(frames[rounds])
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
        "mesh_devices": stats["mesh_devices"], "pipeline": app.close_pipeline.stats(),
    }
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
    meshes = node_close_mesh_legs(load, tmp, card)
    signed = node_close_signed_leg(load, tmp, card)
    plain = node_close_leg(load, tmp, "plain", "cpu", False, untimed_close=False,
                           rounds=NODE_PLAIN_ROUNDS)
    n_timed = len(load.create_ledgers) + NODE_PLAIN_ROUNDS
    assert card["ledger_hashes"] == card_dh["ledger_hashes"], "card legs disagree"
    assert card["ledger_hashes"][:n_timed] == plain["ledger_hashes"], "card and plain disagree"
    assert [ln["bad_tx"] for ln in (card, card_dh, plain)] == ["txBAD_AUTH"] * 3
    assert [ln["stalls"] for ln in (card, card_dh, plain)] == [0, 0, 0], "a dispatch stalled"
    for line in (card, card_dh, *meshes):
        assert line["launches"]["ed25519_verify_signed"] == 0, f"{line['leg']}: a signed launch"
        assert line["launches"]["ed25519_verify_signed_pair"] == 0, f"{line['leg']}: a signed launch"
    for line in (card, card_dh):
        assert line["launches"]["ed25519_verify"] > 0, f"{line['leg']}: no verify launch"
        assert line["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, line["plain_calls"]
        assert line["cpu_cutover_items"] == 0, line
        n_create = sum(len(envs) for envs in load.create_ledgers)
        assert line["txs_applied"] == n_create + NODE_TXS * (NODE_ROUNDS + 1), line["txs_applied"]
    assert card["launches"]["sha512_h"] == 0 and card_dh["launches"]["sha512_h"] > 0
    assert card["launches"]["dh_rows_to_cols"] == 0
    # a device-hash verify chunk launches T1 ahead of its B1 (a torsion
    # chunk launches B1 alone)
    assert 0 < card_dh["launches"]["dh_rows_to_cols"] <= card_dh["launches"]["ed25519_verify"]
    assert plain["launches"]["ed25519_verify"] == 0 and plain["plain_calls"]["ed25519"] > 0
    emit({"phase": "node_close", "hashes_equal": True, "bad_tx": "txBAD_AUTH",
          "ledgers": len(card["ledger_hashes"]),
          "p50_ms": {ln["leg"]: ln["p50_ms"] for ln in (card, card_dh, *meshes, signed, plain)}})
    return {"ed25519_verify": card["launches"]["ed25519_verify"] + card_dh["launches"]["ed25519_verify"],
            "sha512_h": card_dh["launches"]["sha512_h"],
            "dh_rows_to_cols": card_dh["launches"]["dh_rows_to_cols"],
            "mesh_ed25519_verify": sum(ln["launches"]["ed25519_verify"] for ln in meshes),
            "ed25519_verify_signed": signed["launches"]["ed25519_verify_signed"],
            "ed25519_verify_signed_pair": signed["launches"]["ed25519_verify_signed_pair"]}


def node_close_signed_leg(load, tmp, card):
    """``card_signed``: the card leg with the signed-digit windows, the
    module constant ``_SIGNED_WIN`` set for the leg and restored after it.
    Hash for hash with the card leg; every verify launch a signed one (the
    kernel of ``signed_variant``: the wide variant on the 4096-lane chunks,
    the pair on the narrow ones), no plain call, 0 stalls."""
    from stellar_tpu_torch.ops import ed25519 as ed

    was = ed._SIGNED_WIN
    ed._SIGNED_WIN = True
    try:
        leg = node_close_leg(load, tmp, "card_signed", "cuda", False, untimed_close=True)
    finally:
        ed._SIGNED_WIN = was
    assert leg["ledger_hashes"] == card["ledger_hashes"], "card_signed disagrees with the card leg"
    assert leg["launches"]["ed25519_verify"] == 0, f"card_signed reached the unsigned kernel: {leg['launches']}"
    signed = leg["launches"]["ed25519_verify_signed"] + leg["launches"]["ed25519_verify_signed_pair"]
    assert signed > 0, "card_signed never launched a signed kernel"
    by_rule = signed_by_rule(leg["launch_widths"])
    assert by_rule == {k: leg["launches"][k] for k in by_rule}, (by_rule, leg["launches"])
    assert leg["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, leg["plain_calls"]
    assert leg["stalls"] == 0 and leg["bad_tx"] == "txBAD_AUTH" and leg["cpu_cutover_items"] == 0, leg
    return leg


def node_close_mesh_legs(load, tmp, card):
    """The card leg with ``SIG_MESH = "auto"``: ``card_mesh2`` on a host
    whose ``local_devices`` lists the one card twice (the repeated-device
    rig: the node's verify plane two shards wide on the card) and, where
    there are two cards or more, ``card_mesh_cards`` over all of them.
    Each equals the card leg hash for hash, with 0 stalls."""
    import torch

    from stellar_tpu_torch.parallel import mesh as pm

    real = pm.local_devices
    pm.local_devices = lambda kind="cuda": [torch.device("cuda", 0)] * 2
    try:
        legs = [node_close_leg(load, tmp, "card_mesh2", "cuda", False, untimed_close=True,
                               SIG_MESH="auto")]
    finally:
        pm.local_devices = real
    if torch.cuda.device_count() >= 2:
        legs.append(node_close_leg(load, tmp, "card_mesh_cards", "cuda", False,
                                   untimed_close=True, SIG_MESH="auto"))
    for leg, shards in zip(legs, (2, torch.cuda.device_count())):
        assert leg["ledger_hashes"] == card["ledger_hashes"], f"{leg['leg']} disagrees"
        assert leg["mesh_devices"] == shards and card["mesh_devices"] == 0, leg["mesh_devices"]
        assert leg["stalls"] == 0 and leg["bad_tx"] == "txBAD_AUTH", leg
        assert leg["launches"]["ed25519_verify"] > card["launches"]["ed25519_verify"], leg
        assert leg["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, leg["plain_calls"]
    return legs


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
    """While installed, every call of the verify wrapper counts its width
    (lanes) and, with ``keep``, keeps a copy of its input chunk and its
    verdicts (on the card, on the launch's stream), so a run's verdicts can
    be held against the plain version afterwards.  It wraps the wrapper:
    the launch counts are the wrapper's own.  Install it before the nodes
    are built: a verifier binds the wrapper when built."""

    def __init__(self, keep=True):
        from stellar_tpu_torch.ops import ed25519_cuda

        self.mod = ed25519_cuda
        self.launch = ed25519_cuda.verify_packed
        self.keep = keep
        self.calls = []
        self.widths = {}

    def __enter__(self):
        def tapped(p, *args, **kwargs):
            out = self.launch(p, *args, **kwargs)
            self.widths[p.shape[1]] = self.widths.get(p.shape[1], 0) + 1
            if self.keep:
                self.calls.append((p.clone(), out.clone()))
            return out

        self.mod.verify_packed = tapped
        return self

    def __exit__(self, *exc):
        self.mod.verify_packed = self.launch

    def launch_widths(self):
        """{lanes: calls} of the run, by width."""
        return dict(sorted(self.widths.items()))

    def check(self):
        return verify_calls_vs_plain(self.calls)


def signed_by_rule(widths):
    """The launch counts that ``signed_variant`` gives a run of the signed
    windows with these launch widths ({lanes: calls}), keyed as
    ``_node_counts`` keys them."""
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    out = {"ed25519_verify": 0, "ed25519_verify_signed": 0, "ed25519_verify_signed_pair": 0}
    for n, calls in widths.items():
        out["ed25519_verify_signed_pair" if ec.signed_variant(n) == "pair"
            else "ed25519_verify_signed"] += calls
    return out


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
    emit({"phase": "node_consensus", "run": "card", "verdicts_vs_plain": verdicts,
          "launch_widths": tap.launch_widths()})
    assert verdicts["launches"] == c["launches"]["ed25519_verify"], verdicts
    assert verdicts["mismatches"] == 0, verdicts
    signed = consensus_signed_run(tmp, full)
    pair = {}
    for device in ("cuda", "cpu"):
        run = consensus_run(tmp, f"pair-{device}", device, PAIR_ACCOUNTS, PAIR_TXS, PAIR_RATE)
        pair[device] = run
        emit({"phase": "node_consensus", "run": f"pair_{device}", "accounts": PAIR_ACCOUNTS,
              "payments": PAIR_TXS, "ledgers": run["ledgers"], "txs_applied": run["applied"],
              "wall_s": run["wall_s"], **run["counts"],
              "stalls": sum(_stalls(st) for st in run["stats"]),
              "ledger_hashes": run["hashes"][0]})
    assert all(_stalls(st) == 0 for run in pair.values() for st in run["stats"])
    n = min(pair["cuda"]["ledgers"], pair["cpu"]["ledgers"]) - 1
    assert n >= CONSENSUS_LEDGERS - 1
    assert [h[:n] for h in pair["cuda"]["hashes"]] == [h[:n] for h in pair["cpu"]["hashes"]]
    assert pair["cpu"]["counts"]["launches"]["ed25519_verify"] == 0
    assert pair["cpu"]["counts"]["plain_calls"]["ed25519"] > 0
    emit({"phase": "node_consensus", "pair_hashes_equal": n})
    return {"ed25519_verify": c["launches"]["ed25519_verify"],
            "sha256_frames": c["launches"]["sha256_frames_lane"],
            "sha256_frames_pair": c["launches"]["sha256_frames_pair"],
            **{k: signed["launches"][k]
               for k in ("ed25519_verify_signed", "ed25519_verify_signed_pair")}}


def consensus_signed_run(tmp, card):
    """``card_signed``: the full consensus load again with the signed-digit
    windows (``_SIGNED_WIN`` set for the run and for its check, restored
    after): hash for hash with the ``card`` run, every launch a signed one
    of the kernel ``signed_variant`` picks, no plain call, 0 stalls, and
    every launch's verdicts equal to the signed plain version's.  Returns
    the run's counts."""
    from stellar_tpu_torch.ops import ed25519 as ed

    was = ed._SIGNED_WIN
    ed._SIGNED_WIN = True
    try:
        with VerifyTap() as tap:
            run = consensus_run(tmp, "consensus-signed", "cuda", CONSENSUS_ACCOUNTS, CONSENSUS_TXS,
                                CONSENSUS_RATE, bucket_hash_node=0)
        verdicts = tap.check()
    finally:
        ed._SIGNED_WIN = was
    c = run["counts"]
    widths = tap.launch_widths()
    n = min(run["ledgers"], card["ledgers"])
    emit({"phase": "node_consensus", "run": "card_signed", "accounts": CONSENSUS_ACCOUNTS,
          "payments": CONSENSUS_TXS, "ledgers": run["ledgers"], "txs_applied": run["applied"],
          "wall_s": run["wall_s"], "virtual_s": run["virtual_s"], **c,
          "stalls": sum(_stalls(st) for st in run["stats"]), "verdicts_vs_plain": verdicts,
          "launch_widths": widths, "hashes_equal_to_card": n - 1})
    assert run["ledgers"] >= CONSENSUS_LEDGERS
    assert [h[:n - 1] for h in run["hashes"]] == [h[:n - 1] for h in card["hashes"]], \
        "card_signed disagrees with the card run"
    by_rule = signed_by_rule(widths)
    assert by_rule == {k: c["launches"][k] for k in by_rule}, (by_rule, c["launches"])
    assert c["launches"]["ed25519_verify"] == 0, f"card_signed reached the unsigned kernel: {c}"
    assert c["launches"]["ed25519_verify_signed_pair"] > 0, "card_signed never launched the pair"
    assert c["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, c
    assert all(_stalls(st) == 0 for st in run["stats"])
    assert verdicts["mismatches"] == 0 and verdicts["launches"] == sum(widths.values()), verdicts
    return c


# -- phase 11: the chaos scenario on the card --------------------------------


def phase_scenario_flood():
    """``scenario_flood``: the port's ``byzantine_flood_gpu`` class at its
    big spec — a 4-core + 4-tier ring, every node on the gpu backend at
    cutover 0 on the card, 1200 load txs, and ``ByzantineFlood(at=0.5,
    until=20.0, envelopes_per_tick=50, txs_per_tick=10, tick=0.4)`` on node
    0.  The scenario's own floors hold (ledgers agree, every flooded
    envelope rejected, the cache unpolluted); the verify kernel launched,
    the overlay caller class dispatched to the card (the backends'
    ``device_dispatches``) and the plain version never ran; no dispatch
    stalled; every launch's verdicts held against the plain version on the
    card afterwards.  Returns the kernel's launches."""
    from stellar_tpu_torch.scenarios.matrix import big_specs
    from stellar_tpu_torch.scenarios.scenario import Scenario

    spec = big_specs()[FLOOD_CLASS]
    assert (spec.signature_backend, spec.gpu_cpu_cutover, spec.sig_device) == ("gpu", 0, "cuda")
    assert (spec.n_nodes, spec.tier_n, spec.load_txs) == (4, 4, 1200), spec
    flood = spec.faults[0]
    stats = {}
    _node_counts(reset=True)
    t0 = time.perf_counter()
    with VerifyTap() as tap:
        scn = Scenario(spec)
        reached = scn._target_reached

        def check():
            done = reached()
            if done:
                for raw, app in scn.sim.nodes.items():
                    stats[raw.hex()[:8]] = app.sig_backend.stats()
            return done

        scn._target_reached = check
        r = scn.run()
    wall = time.perf_counter() - t0
    counts = _node_counts()
    sb = r.scoreboard
    by_caller = {}
    for st in stats.values():
        for caller, n in st["device_dispatches"].items():
            by_caller[caller] = by_caller.get(caller, 0) + n
    line = {
        "phase": "scenario_flood", "scenario": spec.name, "ok": r.ok, "failures": r.failures,
        "nodes": len(stats), "ledgers": sb.ledgers_closed, "ledgers_per_sec": sb.ledgers_per_sec,
        "wall_s": wall, "virtual_s": sb.wall_seconds, **counts,
        "dispatches_by_caller": dict(sorted(by_caller.items())),
        "lanes": sum(int(p.shape[1]) for p, _ in tap.calls),
        "flood": {"envelopes": flood.n_envelopes, "txs": flood.n_txs,
                  "fast_rejects": sb.fast_rejects,
                  "fast_reject_rate_per_sec": sb.fast_reject_rate_per_sec,
                  "cache_unpolluted": flood.assert_cache_unpolluted()},
        "stalls": sum(_stalls(st) for st in stats.values()),
        "device_calls": [st["device_calls"] for st in stats.values()],
        "cpu_cutover_items": sum(st["cpu_cutover_items"] for st in stats.values()),
        "final_hash": sb.final_hash,
    }
    emit(line)
    assert r.ok, r.failures
    assert len(stats) == 8, f"backend stats of {len(stats)} nodes"
    assert sb.ledgers_agree and sb.ledgers_closed >= 10, (sb.ledgers_agree, sb.ledgers_closed)
    assert sb.fast_rejects == flood.n_envelopes > 0, (sb.fast_rejects, flood.n_envelopes)
    assert line["flood"]["cache_unpolluted"] == flood.n_envelopes
    assert counts["launches"]["ed25519_verify"] > 0 and by_caller.get("overlay", 0) > 0, by_caller
    assert counts["plain_calls"] == {"ed25519": 0, "sha512": 0, "sha256": 0}, counts
    assert line["stalls"] == 0 and line["cpu_cutover_items"] == 0, "a batch stalled or left the card"
    verdicts = tap.check()
    emit({"phase": "scenario_flood", "verdicts_vs_plain": verdicts,
          "launch_widths": tap.launch_widths()})
    assert verdicts["launches"] == counts["launches"]["ed25519_verify"], verdicts
    assert verdicts["mismatches"] == 0, verdicts
    return counts["launches"]["ed25519_verify"]


# -- phase 12: the fuzzer through the CLI -------------------------------------


def phase_fuzz(tmp):
    """``fuzz``: ``--genfuzz`` then ``--fuzz`` through ``python -m
    stellar_tpu_torch.main.cli``, its loopback node pair on the card (the
    CLI's test configs default to the gpu backend on cuda); both exit 0."""
    path = os.path.join(tmp, "fuzz.xdr")
    line = {"phase": "fuzz"}
    for mode in ("genfuzz", "fuzz"):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "stellar_tpu_torch.main.cli", f"--{mode}", path],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
            timeout=600,
        )
        line[f"{mode}_rc"], line[f"{mode}_s"] = p.returncode, time.perf_counter() - t0
        assert p.returncode == 0, f"--{mode}: rc {p.returncode}: {p.stderr[-2000:]}"
    line["corpus_bytes"] = os.path.getsize(path)
    emit(line)


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
        b1_row, b1_packed = phase_kernels(rng, ledger1[0], floor_ms)
        signed_rows = phase_kernel_signed(b1_packed, floor_ms)
        del b1_packed
        dh_lanes = sha512_lanes(rng, ledger1[0])
        t1_row, dh_chunk = phase_kernel_transpose(*dh_lanes, floor_ms)
        rows = [
            b1_row,
            *signed_rows,
            phase_kernel_sha512(dh_chunk, *dh_lanes),
            *phase_kernel_sha256(frames, frame_len),
            t1_row,
        ]
        del dh_lanes, dh_chunk

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

        bench_launches = phase_bench()
        profiler_launches = phase_profilers()
        entry_launches = phase_profile_kernel()

        torsion = phase_torsion(fx, rng, backend, [it[0] for it in ledger1[0][:TORSION_ENCS]])

        with tempfile.TemporaryDirectory(prefix="chip_smoke_node_") as tmp:
            mesh_launches = phase_mesh(fx, tmp, ledger1, scp, torsion)
            close_launches = phase_node_close(fx, tmp)

    bucket_launches = phase_bucket(buf, frames)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_node_") as tmp:
        consensus_launches = phase_node_consensus(tmp)
    flood_launches = phase_scenario_flood()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fuzz_") as tmp:
        phase_fuzz(tmp)

    rows[0]["launches"] = launches["ed25519_verify"]
    rows[3]["launches"] = dh_launches["sha512_h"]
    rows[6]["launches"] = dh_launches["dh_rows_to_cols"]
    rows[4]["launches"] = bucket_launches["lane"]
    rows[5]["launches"] = bucket_launches["pair"]
    # each path's own count, set to 0 just before it and read just after
    rows[0]["launches_by_path"] = {"main_path": launches["ed25519_verify"],
                                   "mesh": mesh_launches["ed25519_verify"],
                                   "node_close": close_launches["ed25519_verify"],
                                   "node_close_mesh": close_launches["mesh_ed25519_verify"],
                                   "node_consensus": consensus_launches["ed25519_verify"],
                                   "scenario_flood": flood_launches,
                                   "bench": bench_launches["ed25519_verify"],
                                   **{path: profiler_launches[path]["ed25519_verify"]
                                      for path in ("profile_close", "state_ladder")},
                                   **{path: entry_launches[path]["ed25519_verify"]
                                      for path in ("graft_entry", "graft_entry_dryrun",
                                                   "profile_kernel", "device_hash_ab",
                                                   "mesh_curve")}}
    # the signed windows' two kernels: the node_close card_signed leg and
    # the node_consensus card_signed run
    for row in rows[1:3]:
        row["launches_by_path"] = {"node_close_signed": close_launches[row["name"]],
                                   "node_consensus_signed": consensus_launches[row["name"]]}
    rows[1]["launches_by_path"]["profile_kernel_ab"] = entry_launches["profile_kernel"][
        "ed25519_verify_signed"]
    for row in rows[1:3]:
        row["launches_by_path"]["mesh_curve"] = entry_launches["mesh_curve"][row["name"]]
    for row in rows[1:3]:
        row["launches"] = sum(row["launches_by_path"].values())
    rows[3]["launches_by_path"] = {"main_path_device_hash": dh_launches["sha512_h"],
                                   "mesh": mesh_launches["sha512_h"],
                                   "node_close": close_launches["sha512_h"],
                                   "bench": bench_launches["sha512_h"],
                                   "device_hash_ab": entry_launches["device_hash_ab"]["sha512_h"],
                                   "mesh_curve": entry_launches["mesh_curve"]["sha512_h"]}
    # T1: one a device-hash chunk (and shard), B2 or not
    rows[6]["launches_by_path"] = {
        "main_path_device_hash": dh_launches["dh_rows_to_cols"],
        "mesh": mesh_launches["dh_rows_to_cols"],
        "node_close": close_launches["dh_rows_to_cols"],
        "bench": bench_launches["dh_rows_to_cols"],
        "device_hash_ab": entry_launches["device_hash_ab"]["dh_rows_to_cols"],
        "mesh_curve": entry_launches["mesh_curve"]["dh_rows_to_cols"]}
    for row, kernel in ((rows[4], "lane"), (rows[5], "pair")):
        row["launches_by_path"] = {"bucket_hash": bucket_launches[kernel],
                                   "node_consensus": consensus_launches[SHA256_KERNELS[kernel]],
                                   **{path: profiler_launches[path][f"sha256_frames_{kernel}"]
                                      for path in ("state_ladder", "hash_ab")}}
    assert all(row["launches"] > 0 for row in rows), {row["name"]: row["launches"] for row in rows}
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
