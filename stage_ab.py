#!/usr/bin/env python3
"""stage_ab.py — time the C host stage (``native/sighash.c``) of other
versions against this checkout's, alone and inside the verify plane.

    python3 stage_ab.py c NAME=SOURCE [NAME=SOURCE ...] [--rounds 75]
    python3 stage_ab.py widths BASELINE_DIR [--rounds 2] [--reps 15]

``c``: builds each ``sighash.c`` as the port builds it (``cc -O2 -shared
-fPIC -pthread``, into a temporary directory) and loads them all into this
process.  Their calls take turns, the order rotated each round, over the
benchmark cell's shape: 32,768 lanes that name 8,192 distinct (pk, msg,
sig) triples four times each in a seeded order, the triples allocated
before the order is drawn, one C-stage thread, one output buffer an entry
reused by every call.  Per entry (``stage_rows``, the cell's, also with the
caches made cold before each call by writing 64 MB, and over the first 1,
904 and 4,096 lanes; ``stage_raw``; ``stage``, the host hash, every fourth
round) and per source it
prints p25 / p50 / p75 of the call's wall ms and, from the five clock
stamps, of the GIL-held ms (prologue and epilogue) and the GIL-released ms
(the pass), plus the source's staged-bytes digest, which must be the same
for every source, and the addresses of its pass functions (``nm -n``).

``widths``: ``BatchVerifier.verify`` wall ms (median of ``--reps`` calls
after one warm-up) with device hash at 1, 904, 4,096 and 32,768 lanes and
with host hash at 4,096, on the card, the C stage on its default threads.
Each side (BASELINE_DIR's package, this checkout's) runs in a process of
its own, in turns: baseline, change, change, baseline, ``--rounds`` times.
Every side's verdicts must be the same.  Prints a line per process, then
the median of each figure per side and the change over baseline.

The triples are random: the gate passes them, the signatures do not verify,
and the stage and the kernels do the same work either way.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.machinery
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import sysconfig
import tempfile
import time

LANES, DISTINCT = 32768, 8192
WIDTHS = ((True, 1), (True, 904), (True, 4096), (True, 32768), (False, 4096))
L = 2**252 + 27742317777372353535851937790883648493


def cell_items(seed: int = 21):
    """The cell's call shape: LANES tuples naming DISTINCT triples, each
    LANES // DISTINCT times, in a seeded order."""
    rng = random.Random(seed)
    pool = [(rng.randbytes(31) + bytes([rng.randrange(128)]), rng.randbytes(32),
             rng.randbytes(32) + rng.randrange(L).to_bytes(32, "little")) for _ in range(DISTINCT)]
    order = list(range(DISTINCT)) * (LANES // DISTINCT)
    rng.shuffle(order)
    return [pool[i] for i in order]


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [round(q[0], 4), round(statistics.median(xs), 4), round(q[2], 4)]


def load(name: str, src: str, tmp: str):
    so = os.path.join(tmp, f"{name}.so")
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-pthread",
                    f"-I{sysconfig.get_paths()['include']}", "-o", so, src], check=True)
    loader = importlib.machinery.ExtensionFileLoader("_sighash", so)
    mod = importlib.util.module_from_spec(importlib.util.spec_from_file_location("_sighash", so,
                                                                                loader=loader))
    loader.exec_module(mod)
    nm = subprocess.run(["nm", "-n", so], capture_output=True, text=True).stdout.split("\n")
    addrs = {ln.split()[2]: ln.split()[0].lstrip("0") for ln in nm
             if ln.count(" ") == 2 and ln.split()[2].startswith(("run_job", "stage_common"))}
    return mod, addrs


def run_c(sources: dict, rounds: int) -> None:
    import numpy as np

    from stellar_tpu_torch.ops import ed25519 as ed

    items = cell_items()
    # (entry, rows a lane, lanes, every how many rounds, caches cold):
    # "cold" writes 64 MB before each call, so the triples come from memory
    entries = {"stage_rows": ("stage_rows", 160, LANES, 1, False),
               "stage_rows/cold": ("stage_rows", 160, LANES, 1, True),
               "stage_rows/1": ("stage_rows", 160, 1, 1, False),
               "stage_rows/904": ("stage_rows", 160, 904, 1, False),
               "stage_rows/4096": ("stage_rows", 160, 4096, 1, False),
               "stage_raw": ("stage_raw", 160, LANES, 1, False),
               "stage": ("stage", 128, LANES, 4, False)}
    flush = np.zeros(64 << 20, dtype=np.uint8)
    # one output buffer an entry, reused as the verifier's pool reuses its
    # own: no call pays for faulting its pages in
    bufs = {e: (np.zeros(rows * n, dtype=np.uint8), np.zeros(n, dtype=np.uint8))
            for e, (_, rows, n, _, _) in entries.items()}
    with tempfile.TemporaryDirectory(prefix="stage_ab_") as tmp:
        mods = {name: load(name, src, tmp) for name, src in sources.items()}
        res = {e: {n: {"wall": [], "held": [], "pass": []} for n in mods} for e in entries}
        digests = {e: {} for e in entries}
        names = list(mods)
        for r in range(rounds):
            order = names[r % len(names):] + names[: r % len(names)]
            for key, (entry, rows, n, every, cold) in entries.items():
                if r % every:
                    continue
                out, ok = bufs[key]
                for name in order:
                    st = np.zeros(6, dtype=np.uint64)
                    if cold:
                        flush += 1
                    t0 = time.perf_counter_ns()
                    getattr(mods[name][0], entry)(items, 0, n, out, ok, ed._BLACKLIST, 1, st)
                    t1 = time.perf_counter_ns()
                    st = st.astype(np.int64)
                    rec = res[key][name]
                    rec["wall"].append((t1 - t0) / 1e6)
                    rec["held"].append(((st[1] - st[0]) + (st[4] - st[3])) / 1e6)
                    rec["pass"].append((st[2] - st[1]) / 1e6)
                    digests[key].setdefault(name, hashlib.sha256(out.tobytes() + ok.tobytes())
                                            .hexdigest()[:16])
    for key in entries:
        assert len(set(digests[key].values())) == 1, (key, digests[key])
        for name in names:
            rec = res[key][name]
            print(json.dumps({"entry": key, "source": name, "calls": len(rec["wall"]),
                              **{k: quartiles(v) for k, v in rec.items()},
                              "digest": digests[key][name], "nm": mods[name][1]}), flush=True)


def measure(tree: str, reps: int) -> dict:
    """One side of ``widths``: its package first on sys.path."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import stellar_tpu_torch

    assert os.path.dirname(os.path.abspath(stellar_tpu_torch.__file__)) == os.path.join(
        tree, "stellar_tpu_torch")
    from stellar_tpu_torch.ops import ed25519 as ed

    items = cell_items()
    out, verdicts = {}, hashlib.sha256()
    for dh in (True, False):
        bv = ed.BatchVerifier(max_batch=LANES, device_hash=dh)
        for want_dh, n in WIDTHS:
            if want_dh != dh:
                continue
            verdicts.update(bytes(bv.verify(items[:n])))
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                bv.verify(items[:n])
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{'device' if dh else 'host'}_hash/{n}"] = statistics.median(times)
    return {"ms": out, "verdicts": verdicts.hexdigest()[:16]}


def run_widths(baseline: str, rounds: int, reps: int) -> None:
    trees = {"baseline": baseline, "change": os.path.dirname(os.path.abspath(__file__))}
    runs = {"baseline": [], "change": []}
    for side in ("baseline", "change", "change", "baseline") * rounds:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "side", trees[side],
                            "--reps", str(reps)], capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"the {side} side failed (rc {r.returncode})")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        runs[side].append(res)
        print(json.dumps({"side": side, **res}), flush=True)
    assert len({r["verdicts"] for rs in runs.values() for r in rs}) == 1, "verdicts differ"
    summary = {}
    for key in runs["change"][0]["ms"]:
        med = {s: statistics.median(r["ms"][key] for r in rs) for s, rs in runs.items()}
        summary[key] = {**med, "change_over_baseline": med["change"] / med["baseline"]}
    print(json.dumps({"summary": summary}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("c", "widths", "side"))
    ap.add_argument("args", nargs="+")
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--reps", type=int, default=15)
    a = ap.parse_args()
    if a.what == "side":
        print(json.dumps(measure(a.args[0], a.reps)))
        return 0
    if a.what == "c":
        run_c(dict(s.split("=", 1) for s in a.args), a.rounds or 75)
    else:
        run_widths(a.args[0], a.rounds or 2, a.reps)
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout)
    except OSError:
        print("nvidia-smi: not found")
    return 0


if __name__ == "__main__":
    sys.exit(main())
