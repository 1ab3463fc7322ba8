#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch/CUDA port's verify plane on one card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero, and no
phase's failure is caught while the run carries on):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — seconds to build the CUDA kernel library and the C host stage
              from the sources in this checkout;
3. kernels  — each ported kernel on the card at the main path's shape
              (4096 packed lanes of mixed valid/invalid/raw classes), held
              against its plain PyTorch version on the same inputs on the
              card: zero mismatches, both verdict classes present; times by
              CUDA events;
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
5. torsion  — ``torsion_check`` on 512 encodings against
              ``ref25519.is_torsion_free``.

Then, on lines of their own: the kernels' JSON line, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.  Keys and messages come from a seed; signatures from libsodium when
the port's ``crypto.sodium`` loads it, else from ref25519 in a process pool.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time

SEED = 20261016
LANES = 4096  # the main path's chunk: SIG_BATCH_MAX
LEDGER_TXS = 5000
MULTISIG_TXS = 1000
SCP_ENVELOPES = 300
TORSION_ENCS = 512
REF_SAMPLE = 256
WIDE_FACTOR = 8
# bound of the verify kernel (csrc/ed25519_verify.cu header note): field
# squarings and multiplications per lane (64 windows, the table of k·(-A),
# decompress, compress), and 32-bit integer multiply-adds (low + high half
# each) per 255-bit operation on 8 words: 8x8 word products for a
# multiplication, 36 for a squaring, plus 8 for the x38 fold of the reduction
FIELD_SQRS_PER_VERIFY = 64 * 16 + 255 + 254
FIELD_MULS_PER_VERIFY = 64 * 28 + 142 + 18 + 13
IMAD_PER_FIELD_SQR = 2 * 36 + 2 * 8
IMAD_PER_FIELD_MUL = 2 * 64 + 2 * 8
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper);
# 3.35 TB/s HBM3 (data sheet) — both at the full 700 W power limit
H100_IMAD_PER_S = 132 * 64 * 1.98e9
H100_BYTES_PER_S = 3.35e12


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
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
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
    ms = cuda_ms(lambda: ec.verify_packed(packed), 7)
    plain_ms = cuda_ms(lambda: ed._verify_packed(packed), 3)
    # the same lanes 8 times over: one thread per lane leaves most of the
    # card's schedulers idle at 4096 lanes; the wide shape shows how far
    wide = packed.repeat(1, WIDE_FACTOR).contiguous()
    ec.verify_packed(wide)
    wide_ms = cuda_ms(lambda: ec.verify_packed(wide), 5)
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
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernels", **row, "wide_lanes": wide.shape[1], "wide_ms": wide_ms})
    return row


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


def phase_main(fx, rng, loads):
    from stellar_tpu_torch.crypto import make_backend
    from stellar_tpu_torch.crypto.sigcache import VerifySigCache
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    tracer = SpanSums()
    backend = make_backend("gpu", cache=VerifySigCache(), tracer=tracer)
    results = []
    ec.launches = 0
    ed.plain_calls = 0
    for name, caller, items, want, run in loads(backend):
        t0 = time.perf_counter()
        got = run(backend, items, caller)
        sec = time.perf_counter() - t0
        results.append((name, caller, items, want, got, sec, tracer.take_ms()))
    launches, plain_calls = ec.launches, ed.plain_calls
    stats = backend.stats()
    for name, caller, items, want, got, sec, spans in results:
        check_load(fx, rng, name, items, want, got)
        emit({
            "phase": "main_path", "load": name, "caller": caller,
            "signatures": len(items), "invalid": want.count(False),
            "ms": sec * 1e3, "verifies_per_s": len(items) / sec,
            "span_ms": spans,
        })
    assert launches > 0, "the main path never launched the CUDA kernel"
    assert plain_calls == 0, f"the plain version ran {plain_calls} times on the main path"
    for key in ("cpu_cutover_items", "stall_rejected_items", "host_assist_items"):
        assert stats[key] == 0, f"{key} = {stats[key]}: items left the device"
    assert stats["wedge_latch_flips"] == {}, f"device stalls: {stats['wedge_latch_flips']}"
    emit({
        "phase": "main_path", "launches": launches, "plain_calls": plain_calls,
        "libsodium_checked": fx.sodium, "stats": stats,
    })
    return backend, launches


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


def sass_instructions(lib: str):
    """Machine instructions in the built library (cuobjdump), or None where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120)
    # an instruction line starts with its address: /*0a70*/
    return len(re.findall(r"^\s*/\*[0-9a-f]{4,}\*/", r.stdout, re.M))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
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

    from stellar_tpu_torch import native

    t0 = time.perf_counter()
    ec.load_library()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_sighash()
    t_host = time.perf_counter() - t0
    with open(ec.library_path()[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "cuda_s": t_cuda, "sighash_s": t_host, "ptxas": ptxas,
          "sass_instructions": sass_instructions(ec.library_path())})

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
        emit({"phase": "fixtures", "seconds": time.perf_counter() - t0,
              "libsodium": fx.sodium})

        row = phase_kernels(rng, ledger1[0])

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

        backend, launches = phase_main(fx, rng, loads)
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

        phase_torsion(fx, rng, backend, [it[0] for it in ledger1[0][:TORSION_ENCS]])

    row["launches"] = launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
