#!/usr/bin/env python3
"""path_ab.py — time the port's unsharded verify path and its kernel
wrappers in this checkout against another checkout of the port, in turns,
on one card.

    python3 path_ab.py BASELINE_DIR [--rounds 2] [--reps 7]

BASELINE_DIR is the root of another checkout of the repo (for example a
commit unpacked with ``git archive`` under the ignored ``_checkout/``).
The two packages share a name, so each side runs in a process of its own
with its checkout first on ``sys.path``, and builds its kernels and C
engines there.  The sides take turns — baseline, change, change, baseline
— ``--rounds`` times.  Every process gets the same inputs, made once here
from ``chip_smoke.py``'s seed and handed over in a temporary file:

- the verify loads of ``chip_smoke.py``'s main path (the 5000-tx ledger,
  the 3-of-5 multisig txset of 3000 signatures, the 300 SCP envelopes),
  each verified by a ``BatchVerifier()`` (unsharded, 4096-lane chunks)
  with host hashing and with device hashing, and through
  ``make_backend("gpu")`` with a fresh verify cache for each call (the
  node's composition): one warm-up call, then the median wall ms of
  ``--reps`` calls; every verdict must equal the known one;
- one wrapped call of each kernel between a pair of CUDA events
  (``chip_smoke.cuda_ms``: the wrapper's host work counts), median of 21:
  B1 ``verify_packed`` on chip_smoke's 4096 packed lanes, B2
  ``hash_in_place`` on its 4096 device-hash lanes, B3 ``digest_rows`` on
  40,000 frames of its bucket frame mix (the sizes that fit in four
  blocks).  The kernels' outputs must be the same on both sides.

Prints one JSON line per process, then one line with the median of each
figure per side and the change / baseline ratio, and the nvidia-smi line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import random
import statistics
import subprocess
import sys
import tempfile
import time

import chip_smoke

CALL_REPS = 21
B3_FRAMES = 40_000


def make_inputs(path: str) -> None:
    """The loads and the kernels' lanes, pickled to ``path``."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    cs = chip_smoke
    rng = random.Random(cs.SEED)
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 1, mp_context=mp.get_context("spawn")) as pool:
        fx = cs.Fixtures(pool)
        ledger = cs.make_load(fx, rng, "ledger1", cs.LEDGER_TXS,
                              lambda k: [hashlib.sha256(b"l1 tx %d" % k).digest()])
        ms_jobs = [[hashlib.sha256(b"multisig tx %d" % (k // 5)).digest()] if k % 5 < 3 else []
                   for k in range(5 * cs.MULTISIG_TXS)]
        multisig = cs.make_load(fx, rng, "multisig", 5 * cs.MULTISIG_TXS, lambda k: ms_jobs[k])
        scp_rng = random.Random(cs.SEED + 1)
        scp_msgs = [bytes(scp_rng.getrandbits(8) for _ in range(scp_rng.randrange(100, 301)))
                    for _ in range(cs.SCP_ENVELOPES)]
        scp = cs.make_load(fx, rng, "validator", cs.SCP_ENVELOPES, lambda k: [scp_msgs[k]])
    # the mix's frames that fit in four blocks, as the flush shape of
    # chip_smoke's kernels phase
    lens, weights = zip(*((n, w) for n, w in cs.BUCKET_FRAME_MIX if (n + 8) // 64 + 1 <= 4))
    frame_rng = random.Random(cs.SEED + 3)
    frames = [frame_rng.randbytes(n) for n in frame_rng.choices(lens, weights, k=B3_FRAMES)]
    data = {
        "loads": {"ledger_5000tx": ledger, "multisig_1000tx_3of5": multisig, "scp_300": scp},
        "b1": cs.kernel_lanes(rng, ledger[0]),
        "b2": cs.sha512_lanes(rng, ledger[0])[0],
        "frames": frames,
    }
    assert data["b1"].dtype == data["b2"].dtype == np.uint8
    with open(path, "wb") as f:
        pickle.dump(data, f)


def wall_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(tree: str, inputs: str, reps: int) -> dict:
    """One side: its package first on sys.path, its figures as a dict."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import stellar_tpu_torch

    pkg = os.path.dirname(os.path.abspath(stellar_tpu_torch.__file__))
    assert pkg == os.path.join(tree, "stellar_tpu_torch"), f"imported {pkg}, not {tree}'s package"
    import torch

    from stellar_tpu_torch.crypto import make_backend
    from stellar_tpu_torch.crypto.sigcache import VerifySigCache
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec
    from stellar_tpu_torch.ops import sha256 as t256
    from stellar_tpu_torch.ops import sha256_cuda as c256
    from stellar_tpu_torch.ops import sha512_cuda as sc

    with open(inputs, "rb") as f:
        data = pickle.load(f)
    out = {"loads_ms": {}, "call_ms": {}, "digests": {}}
    for dh in (False, True):
        tag = "device_hash" if dh else "host_hash"
        bv = ed.BatchVerifier(device_hash=dh)
        for name, (items, want) in data["loads"].items():
            assert bv.verify(items) == want, (tag, name)
            out["loads_ms"][f"verifier/{tag}/{name}"] = wall_ms(lambda: bv.verify(items), reps)

            def through_backend():
                backend = make_backend("gpu", cache=VerifySigCache(), device_hash=dh)
                t0 = time.perf_counter()
                got = backend.verify_batch(items, caller="close")
                sec = time.perf_counter() - t0
                assert got == want, (tag, name)
                return sec * 1e3

            through_backend()
            out["loads_ms"][f"backend/{tag}/{name}"] = statistics.median(
                through_backend() for _ in range(reps))
    p1 = torch.from_numpy(data["b1"]).cuda()
    p2 = torch.from_numpy(data["b2"]).cuda()
    packed, counts = t256.pack_frames(data["frames"], 4)
    p3, nb = torch.from_numpy(packed).cuda(), torch.from_numpy(counts).cuda()
    calls = {
        "ed25519_verify": lambda: ec.verify_packed(p1),
        # each call hashes the rows the last one wrote: the same work
        "sha512_h": lambda: sc.hash_in_place(p2),
        "sha256_frames": lambda: c256.digest_rows(p3, nb),
    }
    for name, fn in calls.items():
        res = fn()
        torch.cuda.synchronize()
        res = p2 if res is None else res
        out["digests"][name] = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()
        out["call_ms"][name] = chip_smoke.cuda_ms(fn, CALL_REPS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print(json.dumps(measure(args.side, args.inputs, args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("path_ab: CUDA is not available", file=sys.stderr)
        return 2
    if not args.baseline or not os.path.isdir(os.path.join(args.baseline, "stellar_tpu_torch")):
        print("path_ab: BASELINE_DIR must hold a stellar_tpu_torch package", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    trees = {"baseline": args.baseline, "change": os.path.dirname(os.path.abspath(__file__))}
    runs = {"baseline": [], "change": []}
    with tempfile.TemporaryDirectory(prefix="path_ab_") as tmp:
        inputs = os.path.join(tmp, "inputs.pkl")
        make_inputs(inputs)
        for side in ("baseline", "change", "change", "baseline") * args.rounds:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side", trees[side],
                 "--inputs", inputs, "--reps", str(args.reps)],
                capture_output=True, text=True, timeout=900,
            )
            if r.returncode != 0:
                print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
                raise RuntimeError(f"the {side} side failed (rc {r.returncode})")
            res = json.loads(r.stdout.strip().splitlines()[-1])
            runs[side].append(res)
            print(json.dumps({"side": side, **res}), flush=True)
    digests = {json.dumps(r["digests"], sort_keys=True) for rs in runs.values() for r in rs}
    assert len(digests) == 1, f"the kernels' outputs differ between the sides: {digests}"
    summary = {}
    for group in ("loads_ms", "call_ms"):
        for key in runs["change"][0][group]:
            med = {side: statistics.median(r[group][key] for r in rs) for side, rs in runs.items()}
            summary[f"{group}/{key}"] = {**med, "change_over_baseline": med["change"] / med["baseline"]}
    print(json.dumps({"summary": summary, "processes": {s: len(rs) for s, rs in runs.items()}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
