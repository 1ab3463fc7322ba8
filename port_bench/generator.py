"""The benchmark's one traffic generator.

A traffic mix is a data file, ``port_bench/traffic/<mix>.json``; this module
reads its parameters and a seed and makes the mix's inputs:

- ``pool``: distinct (public key, message, signature) triples, each key its
  own, each message ``msg_bytes`` bytes, signed by RFC 8032 from keys derived
  from the seed;
- ``bad_share`` of the pool, split evenly over ``bad_classes`` (whole lanes a
  class, rounded), replaced by lanes that libsodium's strict verify refuses:

  - ``flipped_sig_bit``: one bit of a valid S flipped, S kept canonical, so
    the lane passes the input gate and fails the curve equation;
  - ``noncanonical_s``: a valid S plus L (the gate refuses S >= L);
  - ``small_order_a``: A one of the eight 8-torsion points, R = [s]B and a
    message ground until [h]A is the identity, so the cofactorless equation
    holds and only the small-order rule refuses the lane;

- ``orders``: ``orders`` seeded permutations of the pool repeated to
  ``call_items`` lanes, one a call in turn.  Every order holds each pool
  triple the same number of times, so every call of every seed carries the
  same work.

The same seed gives the same bytes on any machine.  RFC 8032 signing is
deterministic, so where the ``cryptography`` package's Ed25519 loads it signs
in process (about 0.1 ms a signature); elsewhere the pure-Python curve
arithmetic (about two milliseconds a signature) runs over a spawn process
pool (``workers``).  Both give the same bytes.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, NamedTuple, Sequence

import numpy as np

from .reference import ed25519 as ref

GOOD = "good"
BAD_CLASSES = ("flipped_sig_bit", "noncanonical_s", "small_order_a")
# pools up to this size are signed and judged in process
_IN_PROCESS = 256


class Traffic(NamedTuple):
    pool: List[tuple]          # (pk, msg, sig) triples, bytes
    classes: List[str]         # GOOD or a bad class, a pool entry each
    orders: List[np.ndarray]   # pool indices of each call order
    calls: List[list]          # the triples of each call order, as the program gets them


def master(seed: int) -> bytes:
    """64 bytes that every other choice of the run derives from."""
    return hashlib.sha512(b"port_bench seed %d" % seed).digest()


def _derive(m: bytes, what: bytes, i: int, n: int = 32) -> bytes:
    """``n`` bytes for (``what``, ``i``), 64 at a time."""
    key = m + what + i.to_bytes(8, "little")
    return b"".join(
        hashlib.sha512(key + j.to_bytes(4, "little")).digest() for j in range(-(-n // 64))
    )[:n]


def _sign(seed32: bytes, msg: bytes) -> tuple:
    """RFC 8032 section 5.1.6 -> (A, R || S)."""
    h = hashlib.sha512(seed32).digest()
    a = int.from_bytes(h[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    pk = ref.encode(ref.base_mult(a))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % ref.L
    big_r = ref.encode(ref.base_mult(r))
    k = int.from_bytes(hashlib.sha512(big_r + pk + msg).digest(), "little") % ref.L
    return pk, big_r + ((r + k * a) % ref.L).to_bytes(32, "little")


def _fast_sign():
    """``_sign`` by the ``cryptography`` package, or None where it does not
    load."""
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
        from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat
    except ImportError:
        return None

    def sign(seed32: bytes, msg: bytes) -> tuple:
        key = Ed25519PrivateKey.from_private_bytes(seed32)
        return key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw), key.sign(msg)

    return sign


def _order(pt) -> int:
    for o in (1, 2, 4, 8):
        if ref.point_eq(ref.scalar_mult(o, pt), ref.IDENTITY):
            return o
    raise ValueError("not a point of the 8-torsion subgroup")


def make_lane(job, sign=_sign) -> tuple:
    """One pool entry: ``job`` = (master, index, class, msg_bytes)."""
    m, i, cls, msg_bytes = job
    msg = _derive(m, b"msg", i, msg_bytes)
    if cls == "small_order_a":
        pts = ref.torsion_points()
        pt = pts[i % len(pts)]
        pk = ref.encode(pt)
        s = int.from_bytes(_derive(m, b"s", i, 64), "little") % ref.L
        big_r = ref.encode(ref.base_mult(s))
        o = _order(pt)
        j = 0
        while True:
            h = int.from_bytes(hashlib.sha512(big_r + pk + msg).digest(), "little") % ref.L
            if h % o == 0:
                break
            j += 1
            msg = _derive(m, b"grind%d" % j, i, msg_bytes)
        return pk, msg, big_r + s.to_bytes(32, "little")
    pk, sig = sign(_derive(m, b"key", i), msg)
    if cls == "flipped_sig_bit":
        s = int.from_bytes(sig[32:], "little")
        k = int.from_bytes(_derive(m, b"bit", i, 8), "little") % 248
        while s ^ (1 << k) >= ref.L:
            k = (k + 1) % 248
        sig = sig[:32] + (s ^ (1 << k)).to_bytes(32, "little")
    elif cls == "noncanonical_s":
        sig = sig[:32] + (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    elif cls != GOOD:
        raise ValueError(f"unknown bad class {cls!r}")
    return pk, msg, sig


def _lanes(jobs) -> list:
    return [make_lane(j) for j in jobs]


def workers() -> int:
    """The CPUs this process may run on, at most 8."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 1
    return max(1, min(8, n))


def over_pool(fn, items: Sequence) -> list:
    """``fn`` over chunks of ``items``, in order: in process for small
    inputs, else over a spawn process pool that is shut down before this
    returns."""
    items = list(items)
    n_workers = workers()
    if len(items) <= _IN_PROCESS or n_workers == 1:
        return fn(items)
    step = -(-len(items) // (4 * n_workers))
    parts = [items[i : i + step] for i in range(0, len(items), step)]
    with ProcessPoolExecutor(n_workers, mp_context=mp.get_context("spawn")) as ex:
        return [r for part in ex.map(fn, parts) for r in part]


def build(mix: dict, seed: int) -> Traffic:
    m = master(seed)
    rng = np.random.default_rng(int.from_bytes(m[:16], "little"))
    n = int(mix["pool"])
    bad = list(mix.get("bad_classes", BAD_CLASSES))
    per_class = round(n * float(mix.get("bad_share", 0.0)) / len(bad)) if bad else 0
    classes = [GOOD] * n
    picked = rng.choice(n, size=per_class * len(bad), replace=False)
    for k, i in enumerate(picked):
        classes[int(i)] = bad[k % len(bad)]
    jobs = [(m, i, classes[i], int(mix["msg_bytes"])) for i in range(n)]
    fast = _fast_sign()
    if fast is not None:
        pool = [make_lane(j, fast) for j in jobs]
    else:
        pool = over_pool(_lanes, jobs)
    call_items = int(mix["call_items"])
    base = np.tile(np.arange(n, dtype=np.int64), -(-call_items // n))
    orders = [rng.permutation(base)[:call_items] for _ in range(int(mix.get("orders", 1)))]
    calls = [[pool[i] for i in o.tolist()] for o in orders]
    return Traffic(pool, classes, orders, calls)
