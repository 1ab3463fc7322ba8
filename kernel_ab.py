#!/usr/bin/env python3
"""kernel_ab.py — time this checkout's build of a kernel against another
build of its source on the same lanes, on one card.

    python3 kernel_ab.py BASELINE.cu [--kernel ed25519_verify|sha512_h|sha256_frames] [--reps 5]

BASELINE.cu must export the same C entry point as every version of the
port's source of that kernel: ``ed25519_verify_launch`` and
``ed25519_const_ints`` with the same constant block for ``ed25519_verify``
(the default), ``sha512_h_launch`` for ``sha512_h``,
``sha256_frames_launch`` for ``sha256_frames``.  It is built with the
port's nvcc flags into a temporary directory; this checkout's kernel is
built as the port builds it.  The lanes are those of ``chip_smoke.py``'s
kernels phase:

- ``ed25519_verify``: the first n of 4096 mixed lanes for n in
  ``VERIFY_WIDTHS`` (the node's launch widths 1, 3, 16 and 64, an SCP
  flush's 300, a 5000-tx ledger's tail chunk of 904, the 4096-lane chunk)
  and the 4096 eight times over (32768);
- ``sha512_h``: 4096 device-hash lanes (``chip_smoke.sha512_lanes``), their
  first 904, and the 4096 eight times over (32768);
- ``sha256_frames``: every shape of ``chip_smoke.sha256_shapes`` on the
  seeded 10^6-record bucket — the launches of the first 4 MB flush and of
  the whole bucket, ``flush_4MB`` and the one-warp chains ``chain_k``.

On each shape both kernels' results must equal the plain version's; then
each is timed by ``chip_smoke.graph_ms`` (launches captured in a CUDA graph,
replayed between one event pair; median of ``--reps`` replays) in turns:
baseline, change, change, baseline.  For ``ed25519_verify`` the signed-digit
instance (``STELLAR_TPU_SIGNED_WINDOWS``) has sides of its own, held against
the signed plain version: ``baseline_signed`` (BASELINE.cu's
``ed25519_verify_signed_launch``, where it exports one) and ``signed``
(this checkout's ``verify_packed(p, signed=True)``, the variant its rule
picks); the turns run baseline, change, baseline_signed, signed and back,
and each line gives ``speedup`` (unsigned, baseline over change),
``signed_speedup`` (baseline_signed over signed) and
``signed_over_change``.  Where this checkout has two signed variants
(``ed25519_cuda.SIGNED_VARIANTS``) a sweep follows: both forced at each
width of ``VERIFY_SWEEP`` (1..32768 lanes; turns wide, pair, pair, wide),
each line with the rule's pick (``signed_variant``) and the faster one.
Prints one JSON line
per shape, the ptxas report of both builds, and the nvidia-smi line.  For ``sha512_h`` it
also prints, per shape, the cycle stamps of block 0's two warps at the
kernel's phase boundaries (this checkout's source built with
``-DSHA512_H_STAMPS``; the phases are named in ``STAMPS``).  For
``sha256_frames`` each line names the kernel that this checkout's rule
picks (``sha256_frames_variant``), and where this checkout exports
``sha256_frames_launch_as`` a sweep follows: both of its kernels, forced,
on the first n lanes of each bucket class at the widths of
``SHA256_SWEEP`` (and of two made-up classes, 1 and 16 blocks; turns
lane, pair, pair, lane), each line with the
rule's pick and whether that pick is the faster kernel there.
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

# the sha256_frames sweep: lane widths of each bucket class (max_blocks),
# from one warp to the whole class; the flush's class widths among them
SHA256_SWEEP = {
    2: (32, 1024, 4096, 8192, 16384, 20480, 24576, 28672, 33523, 36864, 45056, 53248, 65536,
        131072, 262144, 524288, 859934),
    4: (32, 1024, 5042, 16384, 20480, 24576, 28672, 32768, 38573, 45056, 49152, 53248, 57344,
        61440, 65536, 73728, 130129),
    8: (32, 360, 1024, 4096, 9929, 32768, 40960, 49152, 57344, 65536, 98304, 131072),
    # no bucket class of the smoke's bucket: frames cut to 40 bytes (one
    # block) and runs of 8 frames joined (10-16 blocks)
    1: (32, 4096, 16384, 24576, 32768, 40960, 65536),
    16: (32, 1024, 4096, 16384, 24576, 32768, 40960, 65536, 98304, 114688, 131072),
}
SHA256_VARIANTS = ("lane", "pair")
# csrc/sha256_frames.cu's stamp slots, and the shapes stamped: the lane
# kernel stamps 1 + 2b (block b's words merged) and 2 + 2b (compressed);
# the pair 1 (prologue done), 2 (first barrier passed), 3 + 2s (stage s's
# work done), 4 + 2s (its barrier passed); both 47 at the end
SHA256_STAMPS = 48
SHA256_STAMPED = ("chain_2", "chain_4", "chain_5", "flush_class8", "flush_class4", "flush_class2")

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


# the widths of the verify kernel's A/B: the node's launches, its chunks, and
# the chunk eight times over
VERIFY_WIDTHS = (*chip_smoke.NODE_WIDTHS, *chip_smoke.TAIL_LANES[::-1], chip_smoke.LANES,
                 chip_smoke.LANES * chip_smoke.WIDE_FACTOR)
# the signed variants' sweep, 1..32768 lanes: one to a few blocks, the
# widths where a block an SM ends (the pair's 1056, the wide variant's
# 2112) and the resident limits
VERIFY_SWEEP = (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 300, 512, 768, 904, 1024, 1056, 1152,
                1536, 2048, 2112, 2304, 3072, 4096, 4224, 6144, 8192, 12672, 16384, 25344,
                32768)


# csrc/ed25519_verify.cu's pair_stamp(k) points, in k order: the chain
# warp stamps all but 5, the comb warp 0-2 and 4-6 (its 4 is the comb sum)
PAIR_STAMPS = ("start", "constants", "decoded", "table_built", "windows_or_comb_done",
               "comb_handed_over", "joined", "verdict_stored")
PAIR_STAMPED = (1, 64, 904, 2048)


def pair_stamps(packed):
    """Block 0's cycle stamps of this checkout's pair at each width of
    PAIR_STAMPED (the source built with -DED25519_PAIR_STAMPS): one JSON line
    a width, with the SM clock that the chain warp's stamps and the global
    timer give."""
    import numpy as np
    import torch

    from stellar_tpu_torch.ops import ed25519_cuda as ec

    consts, comb = (torch.from_numpy(a).cuda() for a in (ec.kernel_constants(), ec.comb_table()))
    with tempfile.TemporaryDirectory() as tmp:
        lib, _ = build(ec.SOURCE, tmp, "ed25519_pair_stamps", ["-DED25519_PAIR_STAMPS"])
        lib.ed25519_verify_signed_pair_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 3
        lib.ed25519_pair_stamps.argtypes = [ctypes.c_void_p]
        k = len(PAIR_STAMPS)
        for n in PAIR_STAMPED:
            p = packed[:, :n].contiguous()
            out = torch.empty(n, dtype=torch.uint8, device=p.device)
            stamps = np.zeros(2 * k + 2, dtype=np.int64)
            for _ in range(2):  # the second launch's stamps, the code warm
                assert lib.ed25519_verify_signed_pair_launch(
                    p.data_ptr(), out.data_ptr(), n, consts.data_ptr(), comb.data_ptr(),
                    torch.cuda.current_stream().cuda_stream) == 0
                assert lib.ed25519_pair_stamps(stamps.ctypes.data) == 0
            cyc = stamps[:-2].reshape(2, k)
            t0 = cyc[0, 0]
            ns = int(stamps[-1] - stamps[-2])
            warps = {w: {PAIR_STAMPS[j]: int(cyc[i, j] - t0) for j in range(k) if cyc[i, j]}
                     for i, w in enumerate(("chain", "comb"))}
            print(json.dumps({"kernel": "ed25519_verify", "stamps": "pair", "lanes": n,
                              "block0_ns": ns, "ghz": (cyc[0, -1] - cyc[0, 0]) / ns if ns else None,
                              "warps": warps}), flush=True)


def verify_ab(base, packed, reps):
    """The ed25519_verify A/B (module docstring): one JSON line a width,
    then the sweep of the signed variants where this checkout has two."""
    import torch

    from stellar_tpu_torch.ops import ed25519 as ed
    from stellar_tpu_torch.ops import ed25519_cuda as ec

    consts = torch.from_numpy(ec.kernel_constants()).cuda()
    base.ed25519_const_ints.restype = ctypes.c_int
    assert base.ed25519_const_ints() == consts.numel(), "constant blocks differ"

    def base_launcher(fn):
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int

        def run(p):
            out = torch.empty(p.shape[1], dtype=torch.uint8, device=p.device)
            err = fn(p.data_ptr(), out.data_ptr(), p.shape[1], consts.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"baseline launch failed ({err})"
            return out.view(torch.bool)
        return run

    sides = {"baseline": (base_launcher(base.ed25519_verify_launch), False),
             "change": (lambda p: ec.verify_packed(p, signed=False), False)}
    if hasattr(base, "ed25519_verify_signed_launch"):
        sides["baseline_signed"] = (base_launcher(base.ed25519_verify_signed_launch), True)
    sides["signed"] = (lambda p: ec.verify_packed(p, signed=True), True)
    variants = getattr(ec, "SIGNED_VARIANTS", None)
    full = packed.repeat(1, -(-max(VERIFY_SWEEP + VERIFY_WIDTHS) // packed.shape[1])).contiguous()
    plain_4096 = {s: ed._verify_packed(packed, signed=s) for s in (False, True)}
    plain = {s: v.repeat(full.shape[1] // packed.shape[1]) for s, v in plain_4096.items()}

    def turns(fns, p):
        order = list(fns) + list(fns)[::-1]
        t = [chip_smoke.graph_ms(lambda: fn(p), reps=reps) for fn in order]
        return [[t[k], t[-1 - k]] for k in range(len(fns))]

    def mismatches(fns, p, n):
        bad = {}
        for side, (fn, signed) in fns.items():
            got = fn(p)
            torch.cuda.synchronize()
            bad[side] = int((got != plain[signed][:n]).sum())
        assert not any(bad.values()), (n, bad)
        return bad

    for n in VERIFY_WIDTHS:
        p = full[:, :n].contiguous()
        bad = mismatches(sides, p, n)
        ms = dict(zip(sides, turns([fn for fn, _ in sides.values()], p)))
        line = {"kernel": "ed25519_verify", "lanes": n, "accepts": int(plain[False][:n].sum()),
                "mismatches": bad, **{f"{side}_ms": t for side, t in ms.items()},
                "speedup": sum(ms["baseline"]) / sum(ms["change"]),
                "signed_over_change": sum(ms["signed"]) / sum(ms["change"])}
        if "baseline_signed" in ms:
            line["signed_speedup"] = sum(ms["baseline_signed"]) / sum(ms["signed"])
        if variants:
            line["signed_variant"] = ec.signed_variant(n)
        print(json.dumps(line), flush=True)
    if not variants:
        return
    pair_stamps(packed)
    forced = {v: ((lambda p, v=v: ec.verify_packed(p, signed=True, variant=v)), True)
              for v in variants}
    for n in VERIFY_SWEEP:
        p = full[:, :n].contiguous()
        bad = mismatches(forced, p, n)
        ms = dict(zip(forced, turns([fn for fn, _ in forced.values()], p)))
        faster = min(ms, key=lambda v: sum(ms[v]))
        print(json.dumps({"kernel": "ed25519_verify", "sweep": True, "lanes": n, "mismatches": bad,
                          **{f"{v}_ms": ms[v] for v in ms},
                          "pair_over_wide": sum(ms["pair"]) / sum(ms["wide"]),
                          "rule_picks": ec.signed_variant(n), "faster": faster}), flush=True)


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


def sha256_stamps(shapes):
    """Block 0's cycle stamps of each of this checkout's SHA-256 kernels,
    forced, on each shape (the source built with -DSHA256_FRAMES_STAMPS):
    one JSON line a shape and kernel, with the SM clock that the stamps and
    the global timer give."""
    import numpy as np
    import torch

    from stellar_tpu_torch.ops import sha256_cuda as c256

    with tempfile.TemporaryDirectory() as tmp:
        lib, _ = build(c256.SOURCE, tmp, "sha256_frames_stamps", ["-DSHA256_FRAMES_STAMPS"])
        lib.sha256_frames_launch_as.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.sha256_frames_stamps.argtypes = [ctypes.c_void_p]
        for name, (p, nb) in shapes.items():
            n = p.shape[1]
            out = torch.empty((32, n), dtype=torch.uint8, device=p.device)
            for k, kernel in enumerate(SHA256_VARIANTS):
                stamps = np.zeros(2 * SHA256_STAMPS + 2, dtype=np.int64)
                for _ in range(2):  # the second launch's stamps, the code warm
                    assert lib.sha256_frames_launch_as(p.data_ptr(), nb.data_ptr(), out.data_ptr(), n,
                                                       p.shape[0] // 64, k,
                                                       torch.cuda.current_stream().cuda_stream) == 0
                    assert lib.sha256_frames_stamps(stamps.ctypes.data) == 0
                cyc = stamps[:-2].reshape(2, SHA256_STAMPS)
                t0 = cyc[cyc > 0].min()
                ns = int(stamps[-1] - stamps[-2])
                warps = {w: {k2: int(v - t0) for k2, v in enumerate(cyc[w]) if v} for w in range(2)}
                print(json.dumps({"kernel": "sha256_frames", "stamps": kernel, "shape": name,
                                  "block0_ns": ns, "ghz": (cyc[0, -1] - cyc[0, 0]) / ns if ns else None,
                                  "warps": warps}), flush=True)


def sha256_ab(base, reps):
    """The sha256_frames A/B (module docstring): one JSON line a shape,
    then the sweep where this checkout has two kernels."""
    import numpy as np
    import torch

    from stellar_tpu_torch.bucket import hashplane as hp
    from stellar_tpu_torch.ops import sha256 as t256
    from stellar_tpu_torch.ops import sha256_cuda as c256

    base.sha256_frames_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    base.sha256_frames_launch.restype = ctypes.c_int
    lib = c256.load_library()
    sweep = hasattr(lib, "sha256_frames_launch_as")

    def launcher(launch, *extra):
        def run(p, nb):
            out = torch.empty((32, p.shape[1]), dtype=torch.uint8, device=p.device)
            err = launch(p.data_ptr(), nb.data_ptr(), out.data_ptr(), p.shape[1], p.shape[0] // 64,
                         *extra, torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"launch failed ({err})"
            return out
        return run

    def turns(sides, p, nb):
        order = list(sides) + list(sides)[::-1]
        t = [chip_smoke.graph_ms(lambda: fn(p, nb), reps=reps) for fn in order]
        return [[t[k], t[-1 - k]] for k in range(len(sides))]

    def mismatches(sides, p, nb, plain):
        bad = {}
        for side, fn in sides.items():
            got = fn(p, nb)
            torch.cuda.synchronize()
            bad[side] = int((got != plain).any(dim=0).sum())
        return bad

    run_base = launcher(base.sha256_frames_launch)
    stamped = {}
    buf, frame_len = chip_smoke.bucket_buffer(chip_smoke.SEED)
    frames = hp.split_frames(buf)
    del buf
    classes = {}
    for name, msgs, max_blocks in chip_smoke.sha256_shapes(frames, frame_len):
        packed, counts = t256.pack_frames(msgs, max_blocks)
        p, nb = torch.from_numpy(packed).cuda(), torch.from_numpy(counts).cuda()
        if name.startswith("bucket_class"):
            classes[max_blocks] = (p, nb)
        if name in SHA256_STAMPED:
            stamped[name] = (p, nb)
        plain = t256.sha256_rows_from_packed(p, nb).to(torch.uint8)
        sides = {"baseline": run_base, "change": c256.digest_rows}
        bad = mismatches(sides, p, nb, plain)
        host = sides["change"](p, nb).t().contiguous().cpu().numpy()
        for j in random.Random(chip_smoke.SEED).sample(range(len(msgs)), min(len(msgs), 1000)):
            assert host[j].tobytes() == hashlib.sha256(msgs[j]).digest(), (name, j)
        assert not any(bad.values()), (name, bad)
        (b_ms, c_ms) = turns(sides.values(), p, nb)
        line = {"kernel": "sha256_frames", "shape": name, "lanes": len(msgs), "max_blocks": max_blocks,
                "blocks": int(counts.sum()), "mismatches": bad, "baseline_ms": b_ms, "change_ms": c_ms,
                "speedup": sum(b_ms) / sum(c_ms)}
        if sweep:
            line["change_kernel"] = c256.variant(len(msgs), max_blocks)
        print(json.dumps(line), flush=True)
        del p, nb, plain
    if not sweep:
        return
    sha256_stamps(stamped)
    joined = (b"".join(frames[k:k + 8]) for k in range(0, len(frames), 8))
    synthetic = {1: [f[:40] for f in frames[:65536]],
                 16: [m for m in joined if t256.blocks_for(len(m)) <= 16][:131072]}
    for max_blocks, msgs in synthetic.items():
        packed, counts = t256.pack_frames(msgs, max_blocks)
        classes[max_blocks] = (torch.from_numpy(packed).cuda(), torch.from_numpy(counts).cuda())
    launch_as = lib.sha256_frames_launch_as
    forced = {v: launcher(launch_as, k) for k, v in enumerate(SHA256_VARIANTS)}
    for max_blocks, widths in SHA256_SWEEP.items():
        cp, cnb = classes[max_blocks]
        plain_all = t256.sha256_rows_from_packed(cp, cnb).to(torch.uint8)
        for n in widths:
            reps_n = -(-n // cp.shape[1])
            p = cp.repeat(1, reps_n)[:, :n].contiguous()
            nb = cnb.repeat(reps_n)[:n].contiguous()
            plain = plain_all.repeat(1, reps_n)[:, :n]
            bad = mismatches(forced, p, nb, plain)
            assert not any(bad.values()), (max_blocks, n, bad)
            ms = dict(zip(forced, turns(forced.values(), p, nb)))
            pick = c256.variant(n, max_blocks)
            faster = min(ms, key=lambda v: sum(ms[v]))
            print(json.dumps({"kernel": "sha256_frames", "sweep": True, "max_blocks": max_blocks,
                              "lanes": n, "mismatches": bad, **{f"{v}_ms": ms[v] for v in ms},
                              "pair_over_lane": sum(ms["pair"]) / sum(ms["lane"]),
                              "rule_picks": pick, "faster": faster}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline")
    ap.add_argument("--kernel", choices=("ed25519_verify", "sha512_h", "sha256_frames"),
                    default="ed25519_verify")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from stellar_tpu_torch.ops import ed25519_cuda, sha256_cuda, sha512_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.kernel == "sha256_frames":
        with tempfile.TemporaryDirectory() as tmp:
            base, base_ptxas = build(args.baseline, tmp, "sha256_frames_baseline")
            sha256_ab(base, args.reps)
        print(json.dumps({"ptxas": {"baseline": base_ptxas, "change": ptxas_of(sha256_cuda)}}))
        print(smi)
        return 0
    rng = random.Random(chip_smoke.SEED)
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 1, mp_context=mp.get_context("spawn")) as pool:
        fx = chip_smoke.Fixtures(pool)
        items, _ = chip_smoke.make_load(
            fx, rng, "ledger1", chip_smoke.LANES,
            lambda k: [hashlib.sha256(b"l1 tx %d" % k).digest()],
        )
    if args.kernel == "ed25519_verify":
        packed = torch.from_numpy(chip_smoke.kernel_lanes(rng, items)).cuda()
        with tempfile.TemporaryDirectory() as tmp:
            base, base_ptxas = build(args.baseline, tmp, "ed25519_verify_baseline")
            new_ptxas = ptxas_of(ed25519_cuda)
            verify_ab(base, packed, args.reps)
        print(json.dumps({"ptxas": {"baseline": base_ptxas, "change": new_ptxas}}))
        print(smi)
        return 0
    packed = torch.from_numpy(chip_smoke.sha512_lanes(rng, items)[0]).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        base, base_ptxas = build(args.baseline, tmp, "sha512_h_baseline")
        new_ptxas = ptxas_of(sha512_cuda)
        run_base, run_change, plain, widths = sha512_sides(base, packed)
        shapes = {n: packed[:, :n].contiguous() for n in widths}
        wide = chip_smoke.LANES * chip_smoke.WIDE_FACTOR
        shapes[wide] = packed.repeat(1, chip_smoke.WIDE_FACTOR).contiguous()

        def cut(v, n):
            return v.repeat(1, chip_smoke.WIDE_FACTOR) if n == wide else v[..., :n]

        for n, p in shapes.items():
            bad = {}
            for side, fn in (("baseline", run_base), ("change", run_change)):
                got = fn(p)
                torch.cuda.synchronize()
                bad[side] = int((got != cut(plain, n)).any(dim=0).sum())
            assert not any(bad.values()), (n, bad)
            order = [run_base, run_change, run_change, run_base]
            turns = [chip_smoke.graph_ms(lambda: fn(p), reps=args.reps) for fn in order]
            print(json.dumps({
                "kernel": args.kernel, "lanes": n, "mismatches": bad,
                "baseline_ms": [turns[0], turns[-1]], "change_ms": [turns[1], turns[-2]],
                "speedup": (turns[0] + turns[-1]) / (turns[1] + turns[-2]),
            }), flush=True)
        for n, stamps in sha512_stamps(tmp, shapes).items():
            print(json.dumps({"kernel": args.kernel, "lanes": n, "stamps": stamps}), flush=True)
    print(json.dumps({"ptxas": {"baseline": base_ptxas, "change": new_ptxas}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
