#!/usr/bin/env python3
"""kernel_ab.py — time this checkout's build of a kernel against another
build of its source on the same lanes, on one card.

    python3 kernel_ab.py BASELINE.cu [--kernel ed25519_verify|sha512_h] [--reps 5]

BASELINE.cu must export the same C entry point as every version of the
port's source of that kernel: ``ed25519_verify_launch`` and
``ed25519_const_ints`` with the same constant block for ``ed25519_verify``
(the default), ``sha512_h_launch`` for ``sha512_h``.  It is built with the
port's nvcc flags into a temporary directory; this checkout's kernel is
built as the port builds it.  The lanes are those of ``chip_smoke.py``'s
kernels phase:

- ``ed25519_verify``: 4096 mixed lanes, their first 904 (a 5000-tx
  ledger's tail chunk) and first 300 (an SCP flush), and the 4096 eight
  times over (32768);
- ``sha512_h``: 4096 device-hash lanes (``chip_smoke.sha512_lanes``), their
  first 904, and the 4096 eight times over (32768).

On each shape both kernels' results must equal the plain version's; then
each is timed by ``chip_smoke.graph_ms`` (launches captured in a CUDA graph,
replayed between one event pair; median of ``--reps`` replays) in turns:
baseline, change, change, baseline.  Prints one JSON line per shape, the
ptxas report of both builds, and the nvidia-smi line.  For ``sha512_h`` it
also prints, per shape, the cycle stamps of block 0's two warps at the
kernel's phase boundaries (this checkout's source built with
``-DSHA512_H_STAMPS``; the phases are named in ``STAMPS``).
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

# csrc/sha512_h.cu's STAMP(k) points, in k order
STAMPS = ("start", "tile_loaded", "w0_15_written", "first_barrier",
          "stage0_done", "stage1_done", "stage2_done", "stage3_done", "stage4_done",
          "stage0_barrier", "stage1_barrier", "stage2_barrier", "stage3_barrier",
          "tail_start", "h_stored")


def build(source: str, out_dir: str, stem: str, extra=()):
    from stellar_tpu_torch import native

    so = os.path.join(out_dir, f"lib{stem}.so")
    r = subprocess.run(
        [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *native.NVCC_FLAGS, *extra, "-o", so, source],
        capture_output=True, text=True, timeout=600,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr[-4000:]}")
    ptxas = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), ptxas


def ptxas_of(mod):
    mod.load_library()
    with open(mod.library_path()[:-3] + ".log") as f:
        return [ln.strip() for ln in f if "registers" in ln or "spill" in ln]


def verify_sides(base, packed):
    """(baseline, change, plain, shapes) of the verify kernel."""
    import torch

    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    base.ed25519_verify_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    base.ed25519_verify_launch.restype = ctypes.c_int
    base.ed25519_const_ints.restype = ctypes.c_int
    consts = torch.from_numpy(ec.kernel_constants()).cuda()
    assert base.ed25519_const_ints() == consts.numel(), "constant blocks differ"

    def run_base(p):
        out = torch.empty(p.shape[1], dtype=torch.uint8, device=p.device)
        err = base.ed25519_verify_launch(p.data_ptr(), out.data_ptr(), p.shape[1], consts.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"baseline launch failed ({err})"
        return out.view(torch.bool)

    plain = ed._verify_packed(packed)
    return run_base, ec.verify_packed, plain, (chip_smoke.LANES, *chip_smoke.TAIL_LANES)


def sha512_sides(base, packed):
    """(baseline, change, plain, shapes) of the SHA-512 mod L kernel."""
    import torch

    from stellar_tpu_torch.ops import sha512 as tsha
    from stellar_tpu_torch.ops import sha512_cuda as sc

    base.sha512_h_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    base.sha512_h_launch.restype = ctypes.c_int

    def run_base(p):
        out = torch.empty((32, p.shape[1]), dtype=torch.uint8, device=p.device)
        err = base.sha512_h_launch(p.data_ptr(), out.data_ptr(), p.shape[1],
                                   torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"baseline launch failed ({err})"
        return out

    plain = tsha.h_rows_from_packed(packed).to(torch.uint8)
    return run_base, sc.h_rows, plain, (chip_smoke.LANES, chip_smoke.TAIL_LANES[0])


def sha512_stamps(out_dir, shapes):
    """Block 0's cycle stamps of this checkout's sha512_h on each shape:
    {"schedule_warp": {phase: cycles since the first start}, "round_warp":
    {...}}, a phase a warp does not stamp left out."""
    import numpy as np
    import torch

    from stellar_tpu_torch.ops import sha512_cuda as sc

    lib, _ = build(sc.SOURCE, out_dir, "sha512_h_stamps", ["-DSHA512_H_STAMPS"])
    lib.sha512_h_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.sha512_h_stamps.argtypes = [ctypes.c_void_p]
    out = {}
    for n, p in shapes.items():
        h = torch.empty((32, n), dtype=torch.uint8, device=p.device)
        stamps = np.zeros((2, len(STAMPS) + 1), dtype=np.int64)
        for _ in range(2):  # the second launch's stamps, the code warm
            assert lib.sha512_h_launch(p.data_ptr(), h.data_ptr(), n,
                                       torch.cuda.current_stream().cuda_stream) == 0
            assert lib.sha512_h_stamps(stamps.ctypes.data) == 0
        t0 = stamps[:, 0].min()
        out[n] = {warp: {name: int(stamps[w, k] - t0) for k, name in enumerate(STAMPS) if stamps[w, k]}
                  for w, warp in enumerate(("schedule_warp", "round_warp"))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline")
    ap.add_argument("--kernel", choices=("ed25519_verify", "sha512_h"), default="ed25519_verify")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from stellar_tpu_torch.ops import ed25519_cuda, sha512_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rng = random.Random(chip_smoke.SEED)
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 1, mp_context=mp.get_context("spawn")) as pool:
        fx = chip_smoke.Fixtures(pool)
        items, _ = chip_smoke.make_load(
            fx, rng, "ledger1", chip_smoke.LANES,
            lambda k: [hashlib.sha256(b"l1 tx %d" % k).digest()],
        )
    if args.kernel == "ed25519_verify":
        mod, sides, lanes = ed25519_cuda, verify_sides, chip_smoke.kernel_lanes(rng, items)
    else:
        mod, sides, lanes = sha512_cuda, sha512_sides, chip_smoke.sha512_lanes(rng, items)[0]
    packed = torch.from_numpy(lanes).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        base, base_ptxas = build(args.baseline, tmp, f"{args.kernel}_baseline")
        new_ptxas = ptxas_of(mod)
        run_base, run_change, plain, widths = sides(base, packed)
        shapes = {n: packed[:, :n].contiguous() for n in widths}
        wide = chip_smoke.LANES * chip_smoke.WIDE_FACTOR
        shapes[wide] = packed.repeat(1, chip_smoke.WIDE_FACTOR).contiguous()
        for n, p in shapes.items():
            want = plain.repeat(*(1,) * (plain.dim() - 1), chip_smoke.WIDE_FACTOR) if n == wide else plain[..., :n]
            bad = {}
            for side, fn in (("baseline", run_base), ("change", run_change)):
                got = fn(p)
                torch.cuda.synchronize()
                diff = got != want
                bad[side] = int((diff.any(dim=0) if diff.dim() == 2 else diff).sum())
            assert bad == {"baseline": 0, "change": 0}, (n, bad)
            turns = [chip_smoke.graph_ms(lambda: fn(p), reps=args.reps)
                     for fn in (run_base, run_change, run_change, run_base)]
            print(json.dumps({
                "kernel": args.kernel, "lanes": n, "mismatches": bad,
                "baseline_ms": [turns[0], turns[3]], "change_ms": [turns[1], turns[2]],
                "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2]),
            }), flush=True)
        if args.kernel == "sha512_h":
            for n, stamps in sha512_stamps(tmp, shapes).items():
                print(json.dumps({"kernel": args.kernel, "lanes": n, "stamps": stamps}), flush=True)
    print(json.dumps({"ptxas": {"baseline": base_ptxas, "change": new_ptxas}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
