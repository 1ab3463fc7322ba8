#!/usr/bin/env python3
"""kernel_ab.py — time this checkout's verify kernel against another build
of ``ed25519_verify.cu`` on the same packed lanes, on one card.

    python3 kernel_ab.py BASELINE.cu [--reps 7]

BASELINE.cu must export the same C entry points (``ed25519_verify_launch``,
``ed25519_const_ints``) and take the same constant block, as every version
of the port's ``csrc/ed25519_verify.cu`` does.  It is built with the port's
nvcc flags into a temporary directory; this checkout's kernel is built as
the port builds it.  The lanes are those of ``chip_smoke.py``'s kernels
phase: 4096 mixed lanes, their first 904 (a 5000-tx ledger's tail chunk)
and first 300 (an SCP flush), and the 4096 eight times over (32768).  On
each shape both kernels' verdicts must equal the plain version's; then
each is timed by CUDA events (median of ``--reps`` launches) in turns:
baseline, change, change, baseline.  Prints one JSON line per shape, the
ptxas report of both builds, and the nvidia-smi line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import multiprocessing as mp
import os
import random
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor

import chip_smoke


def build_baseline(source: str, out_dir: str):
    from stellar_tpu_torch import native

    so = os.path.join(out_dir, "libed25519_verify_baseline.so")
    r = subprocess.run(
        [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *native.NVCC_FLAGS, "-o", so, source],
        capture_output=True, text=True, timeout=600,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr[-4000:]}")
    ptxas = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(so)
    lib.ed25519_verify_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.ed25519_verify_launch.restype = ctypes.c_int
    lib.ed25519_const_ints.restype = ctypes.c_int
    return lib, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        base, base_ptxas = build_baseline(args.baseline, tmp)
        ec.load_library()
        with open(ec.library_path()[:-3] + ".log") as f:
            new_ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        consts = torch.from_numpy(ec.kernel_constants()).cuda()
        assert base.ed25519_const_ints() == consts.numel(), "constant blocks differ"

        def run_base(p):
            out = torch.empty(p.shape[1], dtype=torch.uint8, device=p.device)
            err = base.ed25519_verify_launch(p.data_ptr(), out.data_ptr(), p.shape[1], consts.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"baseline launch failed ({err})"
            return out.view(torch.bool)

        rng = random.Random(chip_smoke.SEED)
        with ProcessPoolExecutor(max_workers=os.cpu_count() or 1, mp_context=mp.get_context("spawn")) as pool:
            fx = chip_smoke.Fixtures(pool)
            items, _ = chip_smoke.make_load(
                fx, rng, "ledger1", chip_smoke.LANES,
                lambda k: [hashlib.sha256(b"l1 tx %d" % k).digest()],
            )
        packed = torch.from_numpy(chip_smoke.kernel_lanes(rng, items)).cuda()
        plain = ed._verify_packed(packed)
        shapes = {n: packed[:, :n].contiguous() for n in (chip_smoke.LANES, *chip_smoke.TAIL_LANES)}
        wide = chip_smoke.LANES * chip_smoke.WIDE_FACTOR
        shapes[wide] = packed.repeat(1, chip_smoke.WIDE_FACTOR).contiguous()
        for n, p in shapes.items():
            want = plain.repeat(chip_smoke.WIDE_FACTOR) if n == wide else plain[:n]
            bad = {"baseline": int((run_base(p) != want).sum()),
                   "change": int((ec.verify_packed(p) != want).sum())}
            torch.cuda.synchronize()
            assert bad == {"baseline": 0, "change": 0}, (n, bad)
            turns = []
            for fn in (run_base, ec.verify_packed, ec.verify_packed, run_base):
                turns.append(chip_smoke.cuda_ms(lambda: fn(p), args.reps))
            print(json.dumps({
                "lanes": n, "mismatches": bad,
                "baseline_ms": [turns[0], turns[3]], "change_ms": [turns[1], turns[2]],
                "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2]),
            }), flush=True)
    print(json.dumps({"ptxas": {"baseline": base_ptxas, "change": new_ptxas}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
