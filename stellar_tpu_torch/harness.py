"""What the port's entry points (``bench``, ``profile_close``,
``profile_system``, ``profile_kernel``, ``graft_entry``) share: the device
check, the card's name and power limit, the signing pool without
libsodium and the verify oracle.

- ``device()``: ``PROFILE_DEVICE`` (default the card); without CUDA,
  unless it says ``cpu``, one line on stderr and exit 2.
- ``signed(jobs)``: the bytes of ``SecretKey.pseudo_random_for_testing(i)``
  and its signatures, in process with libsodium, else with ref25519 over
  one spawn process pool (the pure-Python reference takes milliseconds a
  signature), which ``close_pool()`` ends; ``sign_seeded(jobs)``:
  signatures by raw seeds over the same pool.
- ``oracle(items)``: the verdicts of (pk, msg, sig) triples by libsodium
  where it loads, else by ref25519's verify over the same pool.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

_pool = None  # the run's process pool without libsodium


# -- the device ---------------------------------------------------------------


def device() -> str:
    """The device the entry points run on: ``PROFILE_DEVICE`` (default the
    card).  Without CUDA, unless it is ``cpu``: one line on stderr, exit 2."""
    import torch

    name = os.environ.get("PROFILE_DEVICE", "cuda")
    try:
        dev = torch.device(name)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cuda", "cpu"):
        print(f"PROFILE_DEVICE={name!r}: want cuda, cuda:N or cpu", file=sys.stderr)
        sys.exit(2)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(
            "CUDA is not available: the profilers and driver entry points run "
            "on the card; set PROFILE_DEVICE=cpu to run the kernels' plain "
            "versions on the CPU",
            file=sys.stderr,
        )
        sys.exit(2)
    return str(dev)


def device_kind(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(dev)


def nvidia_smi(dev):
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return None
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    lines = p.stdout.strip().splitlines()
    return lines[dev.index or 0] if len(lines) > (dev.index or 0) else None


# -- signing and verifying without libsodium ----------------------------------


def _test_seed(i: int) -> bytes:
    """The seed of ``SecretKey.pseudo_random_for_testing(i)``."""
    from .crypto.sha import sha256

    return sha256(b"stellar_tpu test seed %d" % i)


def _sign_job(chunk):
    """[(key index, msg or None)] -> [(pk, msg, sig or None)]: RFC 8032
    with the pure-Python reference (one scalar multiplication for the
    public key, one a signature), in a pool worker."""
    import hashlib

    from .ops import ref25519 as ref

    B = ref.base_point()
    out = []
    for i, msg in chunk:
        h = hashlib.sha512(_test_seed(i)).digest()
        a = int.from_bytes(h[:32], "little")
        a = (a & ((1 << 254) - 8)) | (1 << 254)
        pk = ref.compress(ref.scalar_mult(a, B))
        sig = None
        if msg is not None:
            r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % ref.L
            R = ref.compress(ref.scalar_mult(r, B))
            k = int.from_bytes(hashlib.sha512(R + pk + msg).digest(), "little") % ref.L
            sig = R + ((r + k * a) % ref.L).to_bytes(32, "little")
        out.append((pk, msg, sig))
    return out


def _seeded_job(chunk):
    """[(seed, msg)] -> [signature]: ref25519 in a pool worker."""
    from .ops import ref25519 as ref

    return [ref.sign_with_seed(seed, msg) for seed, msg in chunk]


def _verify_job(chunk):
    """[(pk, msg, sig)] -> [bool]: ref25519's verify, in a pool worker."""
    from .ops import ref25519 as ref

    return [ref.verify(pk, msg, sig) for pk, msg, sig in chunk]


def signing_pool(workers=None):
    """A spawn process pool for the jobs above (a worker takes seconds to
    start: one pool serves a run)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=workers or os.cpu_count() or 1,
                               mp_context=mp.get_context("spawn"))


def close_pool():
    """Shut the run's pool down, if one was started."""
    global _pool
    if _pool is not None:
        _pool.shutdown()
        _pool = None


def _over_pool(job, items, pool=None, chunk=256):
    """``job`` over chunks of ``items`` on ``pool`` (None: the run's pool,
    started on first use), in order."""
    global _pool
    if pool is None:
        if _pool is None:
            _pool = signing_pool()
        pool = _pool
    items = list(items)
    parts = [items[i : i + chunk] for i in range(0, len(items), chunk)]
    return [r for part in pool.map(job, parts) for r in part]


def sign_pool(jobs, pool, chunk=256):
    """``signed``'s ref25519 path over ``pool``."""
    return _over_pool(_sign_job, jobs, pool, chunk)


def signed(jobs):
    """[(key index, msg or None)] -> [(pk, msg, sig or None)], the bytes of
    ``SecretKey.pseudo_random_for_testing(i)`` and its ``sign(msg)``."""
    from .crypto import SecretKey, sodium

    jobs = list(jobs)
    t0 = time.perf_counter()
    if sodium.available():
        out = []
        for i, msg in jobs:
            sk = SecretKey.pseudo_random_for_testing(i)
            out.append((sk.public_raw, msg, None if msg is None else sk.sign(msg)))
    else:
        out = _over_pool(_sign_job, jobs)
    print(
        f"# fixture of {len(jobs)} keys signed in {time.perf_counter() - t0:.1f}s "
        f"({'libsodium' if sodium.available() else 'ref25519 pool'})",
        file=sys.stderr,
    )
    return out


def sign_seeded(jobs):
    """[(32-byte seed, msg)] -> [signature], ref25519 over the run's pool
    (for callers without libsodium)."""
    return _over_pool(_seeded_job, jobs)


def oracle_name() -> str:
    from .crypto import sodium

    return "libsodium" if sodium.available() else "ref25519"


def oracle(items) -> list:
    """The verdicts of (pk, msg, sig) triples: libsodium where it loads,
    else ref25519's verify over the run's pool."""
    from .crypto import sodium

    if sodium.available():
        return [sodium.verify_detached(sig, msg, pk) for pk, msg, sig in items]
    return _over_pool(_verify_job, items)
