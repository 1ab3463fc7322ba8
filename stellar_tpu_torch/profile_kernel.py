#!/usr/bin/env python
"""Device-only verify-kernel timing on the card (developer tool), plus the
device-hash A/B and the multi-device scaling harness.

    python -m stellar_tpu_torch.profile_kernel [batch] [--ab]
    python -m stellar_tpu_torch.profile_kernel --device-hash-ab [--batch 8192]
        [--reps 3] [--out PATH]
    python -m stellar_tpu_torch.profile_kernel --mesh-curve [--cards]
        [--devices 1,2,4,8] [--per-chip 2048] [--reps 3] [--out PATH]
        [--leg-timeout 1500]

``main`` times the verify kernel at batch N (default 32,768) on inputs
staged and copied to the card once, nets out the launch floor (an empty
kernel timed the same way) and prints verifies/s; ``--ab`` runs the
unsigned / signed-window / unsigned A/B/A (B1 against B1s, the signed
variant that ``ed25519_cuda.signed_variant`` picks at N).
``--device-hash-ab`` puts the kernel alone beside two end-to-end rates
through ``BatchVerifier`` (host hash, and SHA-512 on the card ahead of the
verify kernel) and writes ``DEVICE_HASH_torch.json``.  ``--mesh-curve``
runs one child process a device count (``--mesh-leg``) and writes the
per-device retention curve to ``MULTICHIP_torch.json``.

The port's twin of the repository's root ``profile_kernel.py``: its modes,
flags, defaults, printed lines, JSON keys and exit codes.  Differences
(ROADMAP, "Recorded contract differences"):

- every mode runs on ``PROFILE_DEVICE`` (default the card; ``cpu`` runs the
  kernels' plain versions).  Without CUDA, unless it says ``cpu``, one line
  naming CUDA goes to stderr and the run exits 2 with nothing measured.
  ``--tpu`` has no counterpart: it exits 2 with a line naming ``--cards``;
- ``rtt`` (``dispatch_rtt_ms``) is the launch floor, an empty kernel timed
  as the kernel is (CUDA events around one call), not a relay's round trip;
- the JSON names the device (``device``: the card's name, or ``cpu``) where
  the JAX records name ``jax_backend``; ``kernel_backend`` is ``cuda`` or
  ``plain``; the device-hash record adds ``nvidia_smi``, and each mesh leg
  adds ``mesh`` (its devices), ``launches`` (each kernel's, by name) and
  ``plain_calls`` (the plain versions' calls, 0 on the card).  The
  numbers are not rounded;
- ``--device-hash-ab`` gates (rc 1 below the 0.9 floor) on the card, never
  on the CPU;
- a mesh leg runs the repeated-device rig ``[PROFILE_DEVICE] * n`` (one
  card, ``effective_chips`` 1: its retention isolates the sharded dispatch's
  overhead), or with ``--cards`` n distinct cards (``effective_chips`` n),
  skipped where fewer exist.  No ``min_device_batch``;
- the records are ``DEVICE_HASH_torch.json`` and ``MULTICHIP_torch.json`` in
  the working directory; the JAX package's records are never written;
- without libsodium the fixtures are signed with ref25519 over
  ``harness``'s spawn process pool, and the mixed-lane oracle is
  ref25519's verify.

A kernel that fails to build or launch ends the run; nothing falls back to
a plain version.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import harness

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's records (DEVICE_HASH_r16.json, MULTICHIP_r13.json, ...)
_JAX_RECORD = re.compile(r"(DEVICE_HASH|MULTICHIP)(_TPU)?_r\d+\.json")


def _own_record(path: str) -> str:
    if _JAX_RECORD.fullmatch(os.path.basename(path)):
        raise ValueError(f"{path} is a record of the JAX package; the port writes its own")
    return path


def _best_ms(device, fn, reps: int) -> float:
    """Best of ``reps`` calls of ``fn``, in ms: CUDA events around one call
    on the card (the wrapper's host work counts, as the relay's round trip
    did in the JAX harness), the host clock on the CPU."""
    import torch

    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def _floor_ms(arr) -> float:
    """The launch floor, the JAX harness's dispatch RTT: an empty kernel on
    the card (a trivial op on the CPU), timed as the kernel is."""
    from .ops import sha512_cuda as sc

    if arr.is_cuda:
        def trivial():
            sc.launch_noop(arr.device)
    else:
        def trivial():
            return arr[0] + 1
    trivial()
    return _best_ms(arr.device, trivial, 5)


def _upload(bv, items):
    """``items`` staged by ``bv``'s host stage, copied to its device once."""
    staged = bv._stage_chunk(items, 0, len(items))
    arr = staged.shards[0].packed.to(bv.device)
    bv._release(staged)
    return arr


def main(batch=32768, ab=False, reps=5):
    """Device-only verify timing at ``batch`` lanes on ``PROFILE_DEVICE``,
    best of ``reps`` calls a leg (the CLI keeps 5; the CPU tests take 1, a
    plain call costing about a second there); without ``ab`` the
    one leg's windows are those ``STELLAR_TPU_SIGNED_WINDOWS`` picks.
    Returns the legs' numbers."""
    import torch

    from .ops import ed25519 as ed
    from .ops import ed25519_cuda as ec
    from .ops.ed25519 import BatchVerifier

    device = torch.device(harness.device())
    bv = BatchVerifier(max_batch=batch, device=device)
    items = harness.signed((i, b"kernel profile %08d" % i) for i in range(batch))
    arr = _upload(bv, items)
    rtt = _floor_ms(arr)
    print(f"# device {harness.device_kind(device)}: unsigned B1; signed windows: "
          f"{'B1s ' + ec.signed_variant(batch) if device.type == 'cuda' else 'plain'} "
          f"at {batch} lanes", flush=True)
    legs = []

    def leg(signed):
        signed = ed._SIGNED_WIN if signed is None else signed
        ok = ec.verify_packed(arr, signed=signed)
        assert bool(ok.all()), "profile signatures must verify"
        best = _best_ms(device, lambda: ec.verify_packed(arr, signed=signed), reps)
        net = max(1e-9, best - rtt)
        tag = "signed-window" if signed else "unsigned"
        print(
            f"batch {batch} [{tag}]: kernel call best {best:.1f} ms "
            f"(rtt {rtt:.1f} ms) -> net {net:.1f} ms = "
            f"{batch / net * 1e3:,.0f} verifies/s device-only",
            flush=True,
        )
        kernel = (ec.signed_variant(batch) if signed else "unsigned") if arr.is_cuda else "plain"
        legs.append({"signed": signed, "kernel": kernel,
                     "best_ms": best, "net_ms": net, "verifies_per_s": batch / net * 1e3})
        return net

    out = {"batch": batch, "device": harness.device_kind(device), "rtt_ms": rtt, "legs": legs}
    if ab:
        # same-process A/B/A; order off/on/off controls drift
        off1 = leg(False)
        on = leg(True)
        off2 = leg(False)
        out["gain"] = 1.0 - on / min(off1, off2)
        print(f"signed-window gain vs best unsigned leg: {out['gain']:+.1%}")
    else:
        leg(None)
    return out


def device_hash_ab(batch: int, reps: int, out_path: str) -> int:
    """Same-call paired device-hash A/B — the three numbers:

      rate_kernel_only       device-resident verify kernel calls (inputs
                             staged and copied once; launch floor netted out)
      rate_e2e_host_hash     BatchVerifier.verify, the C host stage hashing
      rate_e2e_device_hash   BatchVerifier.verify, SHA-512 on the card ahead
                             of the verify kernel (``device_hash=True``)

    Both end-to-end verifiers first prove the mixed hostile-lane mask
    exact against the oracle.  Writes ``out_path``; exits 1 on the card when
    rate_e2e_device_hash < 0.9 * rate_kernel_only (on the CPU the record is
    written without a gate)."""
    import torch

    from .graft_entry import _mixed_lane_items
    from .ops.ed25519 import BatchVerifier

    _own_record(out_path)
    device = torch.device(harness.device())
    gated = device.type == "cuda"
    bv_host = BatchVerifier(max_batch=batch, streams=1, device_hash=False, device=device)
    bv_dev = BatchVerifier(max_batch=batch, streams=1, device_hash=True, device=device)
    batch = bv_host.max_batch

    # oracle first: the mixed valid/corrupt-R/corrupt-s/bad-A mask must be
    # exact on BOTH layouts before anything is timed
    t0 = time.perf_counter()
    mixed, want = _mixed_lane_items(batch)
    for bv, tag in ((bv_host, "host-hash"), (bv_dev, "device-hash")):
        got = np.asarray(bv.verify(mixed))
        assert (got == want).all(), (
            f"{tag} verdicts diverge from the oracle at lanes "
            f"{np.nonzero(got != want)[0][:8].tolist()}"
        )
    compile_s = time.perf_counter() - t0

    items = harness.signed((900_000 + i, b"device hash ab %08d" % i) for i in range(batch))

    # kernel-only: one staged upload, then repeated device-resident calls
    arr = _upload(bv_host, items)
    bv_host._run_kernels(arr, device)
    rtt = _floor_ms(arr)
    kt = _best_ms(device, lambda: bv_host._run_kernels(arr, device), reps)
    assert bool(bv_host._run_kernels(arr, device)[: len(items)].all())
    kernel_only = batch / max(1e-9, (kt - rtt) / 1e3)

    def e2e(bv):
        best = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            out = bv.verify(items)
            dt = time.perf_counter() - t0
            assert all(out)
            best = max(best, len(items) / dt)
        return best

    e2e_host = e2e(bv_host)
    e2e_dev = e2e(bv_dev)
    floor = 0.9
    ok_gate = e2e_dev >= floor * kernel_only
    result = {
        "round": "r16",
        "harness": "python -m stellar_tpu_torch.profile_kernel --device-hash-ab",
        "device": harness.device_kind(device),
        "kernel_backend": "cuda" if device.type == "cuda" else "plain",
        "batch": batch,
        "reps": reps,
        "mixed_oracle_exact_both_layouts": True,
        "compile_plus_oracle_s": compile_s,
        "dispatch_rtt_ms": rtt,
        "rate_kernel_only": kernel_only,
        "rate_e2e_host_hash": e2e_host,
        "rate_e2e_device_hash": e2e_dev,
        "e2e_device_hash_vs_kernel_only": e2e_dev / kernel_only,
        "device_hash_vs_host_hash": e2e_dev / max(1e-9, e2e_host),
        "floor": floor,
        "ok": ok_gate,
        "gated": gated,
        "nvidia_smi": harness.nvidia_smi(device),
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps(result), flush=True)
    return 0 if (ok_gate or not gated) else 1


def _curve_fixtures(n):
    """(mixed lanes, their mask, curve items) of ``n`` lanes.  Lane i of
    each depends on i alone, so a leg of fewer lanes takes a prefix."""
    from .graft_entry import _mixed_lane_items

    mixed, want = _mixed_lane_items(n)
    items = harness.signed((500_000 + i, b"mesh curve %08d" % i) for i in range(n))
    return mixed, want, items


def _dump_fixtures(fixtures, path):
    mixed, want, items = fixtures
    with open(path, "w") as f:
        json.dump({"mixed": [[b.hex() for b in it] for it in mixed], "want": want.tolist(),
                   "items": [[b.hex() for b in it] for it in items]}, f)


def _load_fixtures(path):
    with open(path) as f:
        d = json.load(f)
    return ([tuple(bytes.fromhex(h) for h in it) for it in d["mixed"]],
            np.asarray(d["want"], dtype=bool),
            [tuple(bytes.fromhex(h) for h in it) for it in d["items"]])


def _leg_lanes(n_devices: int, per_chip: int, cards: bool) -> int:
    """The most lanes a leg can verify: per_chip x effective chips, rounded
    up to whole shards as ``BatchVerifier`` rounds ``max_batch``."""
    lanes = per_chip * (n_devices if cards else 1)
    return max(n_devices, -(-lanes // n_devices) * n_devices)


def mesh_leg(n_devices: int, per_chip: int, reps: int, cards: bool = False,
             fixtures=None) -> int:
    """One curve point, run in a child process.  Proves the mixed-lane
    oracle mask (incl. a remainder batch) exact on this mesh FIRST, then
    times uniform valid batches end-to-end through ``BatchVerifier.verify``
    (host gate + staging + sharded dispatch + drain) and prints one
    ``MESH_LEG {json}`` line.  ``fixtures``: a file of ``_curve_fixtures``
    (``mesh_curve`` signs once for every leg), else the leg signs its own."""
    from .ops import ed25519 as ed
    from .ops import ed25519_cuda as ec
    from .ops import resolve_device
    from .ops import sha512 as tsha
    from .ops import sha512_cuda as sc
    from .ops.ed25519 import BatchVerifier
    from .parallel import mesh as pmesh

    device = resolve_device(harness.device())
    if cards:
        devs = pmesh.local_devices(device.type)
        if len(devs) < n_devices:
            print("MESH_LEG " + json.dumps({
                "n_devices": n_devices,
                "skipped": f"only {len(devs)} addressable device(s)",
            }), flush=True)
            return 0
        devs = devs[:n_devices]
    else:
        devs = [device] * n_devices
    host_cores = os.cpu_count() or 1
    # effective chips: the distinct devices — shards that repeat one card
    # time-slice it, so per-chip retention on the rig isolates the sharded
    # dispatch's overhead against the single-queue path
    eff = len(set(devs))
    batch = per_chip * eff
    if n_devices > 1:
        bv = BatchVerifier(max_batch=batch, mesh=pmesh.make_mesh(devs))
    else:
        # the 1-device point is the PRODUCTION single-queue path — the
        # baseline sharded dispatch must retain
        bv = BatchVerifier(max_batch=batch, device=devs[0])
    batch = bv.max_batch  # granule rounding (whole shards)
    if fixtures:
        mixed, want, items = _load_fixtures(fixtures)
    else:
        mixed, want, items = _curve_fixtures(batch)
    mixed, want, items = mixed[:batch], want[:batch], items[:batch]
    t0 = time.perf_counter()
    got = np.asarray(bv.verify(mixed))
    assert (got == want).all(), (
        f"sharded verdicts diverge from the oracle at lanes "
        f"{np.nonzero(got != want)[0][:8].tolist()}"
    )
    rem = batch - max(1, n_devices - 1)  # live lanes % n_devices != 0
    got_rem = np.asarray(bv.verify(mixed[:rem]))
    assert (got_rem == want[:rem]).all(), "remainder chunk diverges"
    compile_s = time.perf_counter() - t0
    out = bv.verify(items)  # warm pass
    assert all(out), "curve signatures must all verify"
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = bv.verify(items)
        times.append(time.perf_counter() - t0)
        assert all(out)
    best = min(times)
    leg = {
        "n_devices": n_devices,
        "effective_chips": eff,
        "host_cores": host_cores,
        "device": harness.device_kind(device),
        "kernel_backend": "cuda" if device.type == "cuda" else "plain",
        "sharded": bv.mesh is not None,
        "mesh": [str(d) for d in devs],
        "batch": batch,
        "device_calls": bv.n_device_calls,
        "launches": {"ed25519_verify": ec.launches, "ed25519_verify_signed": ec.signed_launches,
                     "ed25519_verify_signed_pair": ec.signed_pair_launches,
                     "sha512_h": sc.launches, "dh_rows_to_cols": sc.transpose_launches},
        "plain_calls": {"ed25519": ed.plain_calls, "sha512": tsha.plain_calls},
        "reps_s": times,
        "best_s": best,
        "verifies_per_sec": batch / best,
        "verifies_per_sec_per_chip": batch / best / eff,
        "mixed_oracle_exact": True,
        "compile_plus_oracle_s": compile_s,
    }
    print("MESH_LEG " + json.dumps(leg), flush=True)
    return 0


def mesh_curve(dev_counts, per_chip, reps, cards, out_path, leg_timeout=1500.0) -> int:
    """Run one child per device count and write the scaling curve.

    Every leg's captured tail is run through filter_xla_noise and capped:
    the records carry verdict lines, never pages of output."""
    from .graft_entry import filter_xla_noise
    from .ops import resolve_device

    _own_record(out_path)
    device = resolve_device(harness.device())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
    legs, failures = [], []
    with tempfile.TemporaryDirectory(prefix="profile_kernel_") as tmp:
        # sign once for every leg (without libsodium each child would start
        # its own signing pool)
        fixtures = os.path.join(tmp, "fixtures.json")
        _dump_fixtures(_curve_fixtures(max(_leg_lanes(n, per_chip, cards) for n in dev_counts)),
                       fixtures)
        for n in dev_counts:
            argv = [
                sys.executable, "-u", "-m", "stellar_tpu_torch.profile_kernel",
                "--mesh-leg", str(n),
                "--per-chip", str(per_chip),
                "--reps", str(reps),
                "--fixtures", fixtures,
            ]
            if cards:
                argv.append("--cards")
            print(f"# mesh-curve: leg n_devices={n} starting", flush=True)
            try:
                proc = subprocess.run(
                    argv, env=env, capture_output=True, text=True, timeout=leg_timeout,
                )
            except subprocess.TimeoutExpired:
                failures.append({"n_devices": n, "error": f"timed out after {leg_timeout:.0f}s"})
                continue
            leg = None
            for line in proc.stdout.splitlines():
                if line.startswith("MESH_LEG "):
                    leg = json.loads(line[len("MESH_LEG "):])
            if proc.returncode != 0 or leg is None:
                failures.append({
                    "n_devices": n,
                    "rc": proc.returncode,
                    "tail": filter_xla_noise(proc.stdout + "\n" + proc.stderr, cap=800).strip(),
                })
                continue
            if tail := filter_xla_noise(proc.stderr, cap=300).strip():
                leg["tail"] = tail
            legs.append(leg)
            print(f"#   leg done: {json.dumps(leg)}", flush=True)
    measured = [l for l in legs if "verifies_per_sec_per_chip" in l]
    skipped = [l for l in legs if "skipped" in l]
    curve = {str(l["n_devices"]): l["verifies_per_sec_per_chip"] for l in measured}
    retention = None
    if len(measured) > 1:
        base = min(measured, key=lambda l: l["n_devices"])
        top = max(measured, key=lambda l: l["n_devices"])
        retention = top["verifies_per_sec_per_chip"] / base["verifies_per_sec_per_chip"]
    # a certification needs the whole curve: a skipped leg (too few cards)
    # or a single measured point must NOT exit 0 with "ok": true
    ok = (
        len(measured) > 1
        and not failures
        and not skipped
        and retention is not None
        and retention >= 0.7
    )
    result = {
        "round": "r13",
        "harness": "python -m stellar_tpu_torch.profile_kernel --mesh-curve"
        + (" --cards" if cards else ""),
        "oracle": (
            "cards (n distinct devices of parallel.mesh.local_devices, one child per leg)"
            if cards
            else f"repeated-device rig ([{device}] * n, one child per leg)"
        ),
        "per_chip_batch": per_chip,
        "reps_per_leg": reps,
        "host_cores": os.cpu_count() or 1,
        "methodology": (
            "weak scaling: each leg verifies per_chip_batch x "
            "effective_chips items end-to-end through BatchVerifier.verify "
            "(host strict gate + SHA-512 staging + per-shard upload + "
            "sharded dispatch + drain), best-of-reps.  effective_chips is "
            "the mesh's distinct devices: on the repeated-device rig (one "
            "card, or the CPU, named n times) it is 1, every shard "
            "time-slices the same device, so per-chip retention there "
            "isolates the sharded DISPATCH's overhead against the "
            "single-queue path; real per-card scaling is what the --cards "
            "leg measures.  Every leg first proves the mixed valid/"
            "corrupt-R/corrupt-s/bad-A lane mask (plus a remainder batch, "
            "live lanes % n_devices != 0) exact against the oracle "
            "(libsodium, else ref25519) on the same mesh."
        ),
        "verifies_per_sec_per_chip": curve,
        "per_chip_retention_at_max_devices": retention,
        "retention_floor": 0.7,
        "legs": legs,
        "failures": failures,
        "skipped_legs": [l["n_devices"] for l in skipped],
        "ok": ok,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({"mesh_curve_per_chip": curve, "retention": retention, "ok": ok,
                      "out": out_path}), flush=True)
    return 0 if ok else 1


def _flag_val(argv, name, default):
    if name in argv:
        i = argv.index(name)
        if i + 1 >= len(argv):
            sys.exit(f"profile_kernel: {name} needs a value")
        return argv[i + 1]
    return default


def _cli(argv) -> int:
    if "--tpu" in argv:
        print("profile_kernel: --tpu has no counterpart in the port: every mode runs on "
              "PROFILE_DEVICE (default the card); --mesh-curve --cards takes n distinct "
              "cards", file=sys.stderr)
        return 2
    harness.device()  # no card, no run: exit 2 before anything is measured
    try:
        if "--device-hash-ab" in argv:
            return device_hash_ab(
                int(_flag_val(argv, "--batch", "8192")),
                int(_flag_val(argv, "--reps", "3")),
                os.path.abspath(_flag_val(argv, "--out", "DEVICE_HASH_torch.json")),
            )
        if "--mesh-leg" in argv:
            return mesh_leg(
                int(_flag_val(argv, "--mesh-leg", "1")),
                int(_flag_val(argv, "--per-chip", "2048")),
                int(_flag_val(argv, "--reps", "3")),
                cards="--cards" in argv,
                fixtures=_flag_val(argv, "--fixtures", None),
            )
        if "--mesh-curve" in argv:
            return mesh_curve(
                [int(c) for c in _flag_val(argv, "--devices", "1,2,4,8").split(",")],
                int(_flag_val(argv, "--per-chip", "2048")),
                int(_flag_val(argv, "--reps", "3")),
                "--cards" in argv,
                os.path.abspath(_flag_val(argv, "--out", "MULTICHIP_torch.json")),
                leg_timeout=float(_flag_val(argv, "--leg-timeout", "1500")),
            )
        args = [a for a in argv if a != "--ab"]
        main(int(args[0]) if args else 32768, ab="--ab" in argv)
        return 0
    finally:
        harness.close_pool()


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
