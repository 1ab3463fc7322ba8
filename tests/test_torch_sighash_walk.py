"""The C host stage reads each lane's bytes through the lane's tuple.

``native/sighash.c`` takes one reference a lane, on the lane's item tuple,
with the GIL held, and reads the tuple's last three slots in its
GIL-released pass.  A lane whose slots are not all exact ``bytes`` is left
by the pass and staged once the GIL is back: a ``bytes`` subclass as bytes,
anything else raising ``TypeError``.  These tests hold ``stage``,
``stage_raw`` and ``stage_rows`` against the Python stage
(``BatchVerifier._stage_py`` / ``_stage_py_raw``): the bytes, the verdicts,
the rejects and the flag-1 count, at several widths, offsets, thread counts
and tuple sizes; the count of lanes staged with the GIL held (the stamp
buffer's sixth slot, and the ``gil_lanes`` attribute of the
``ed25519.host_hash`` span); the errors and what they leave in the
buffers; and the reference counts of every tuple and bytes object.
``tests/test_torch_native_sanitize.py`` runs the same lanes, and a list
rebound by another thread during the call, under the sanitizers.
"""

from __future__ import annotations

import random
import sys
from collections import namedtuple

import numpy as np
import pytest
import torch

from stellar_tpu_torch import native
from stellar_tpu_torch.ops import ed25519 as ted
from stellar_tpu_torch.ops import ref25519 as ref
from stellar_tpu_torch.ops import sha512 as tsha
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MODES = ("stage", "stage_raw", "stage_rows")
SLOT_ERROR = "sighash.stage needs immutable bytes items, got {}"
TUPLE_ERROR = "items must be tuples of >= 3 slots (..., pk, msg, sig)"


class SubBytes(bytes):
    """A bytes subclass: staged as bytes, with the GIL held."""


# a tuple subclass: read through like a tuple, without the GIL
Lane = namedtuple("Lane", "pk msg sig")


def _lanes(n, rng, slots=3):
    """n (pk, msg, sig) tuples, with a leading index slot when ``slots`` is
    4 and as ``Lane`` namedtuples when it is "named", of every class the
    stage tells apart: gate-passing lanes with
    messages of one and of several SHA-512 blocks, s >= L, small-order A
    and R, short keys and signatures.  The signatures need not verify: the
    stage gates, hashes and lays out bytes."""
    bl = ref.small_order_blacklist()
    out = []
    for i in range(n):
        pk = rng.randbytes(32)
        msg = rng.randbytes(rng.choice((0, 1, 32, 47, 48, 111, 112, 200)))
        sig = rng.randbytes(32) + rng.randrange(ref.L).to_bytes(32, "little")
        cls = i % 9
        if cls == 4:
            sig = sig[:32] + (ref.L + rng.randrange(1000)).to_bytes(32, "little")
        elif cls == 5:
            pk = rng.choice(bl)
        elif cls == 6:
            sig = rng.choice(bl) + sig[32:]
        elif cls == 7:
            pk = pk[:31]
        elif cls == 8:
            sig = sig[:63]
        out.append((i, pk, msg, sig) if slots == 4 else Lane(pk, msg, sig) if slots == "named"
                   else (pk, msg, sig))
    return out


def _rows(mode):
    return ted.ROWS if mode == "stage" else tsha.DH_ROWS


def _c_stage(mode, items, start, n, threads, stride=None):
    """The C stage into fresh 0xA5-filled buffers -> ((rows, stride) bytes,
    ok, rejects, flagged, lanes staged with the GIL held)."""
    rows, stride = _rows(mode), n if stride is None else stride
    item_major = mode == "stage_rows"
    out = np.full((stride, rows) if item_major else (rows, stride), 0xA5, dtype=np.uint8)
    ok = np.full(n, 9, dtype=np.uint8)
    stamps = np.zeros(6, dtype=np.uint64)
    res = getattr(native.load_sighash(), mode)(items, start, n, out, ok, ted._BLACKLIST,
                                                threads, stamps)
    rejects, flagged = res if item_major else (res, None)
    return out.T if item_major else out, ok, rejects, flagged, int(stamps[5])


def _py_stage(mode, items, start, n):
    """The Python stage -> ((rows, n) bytes, ok, rejects, flagged)."""
    packed = np.full((_rows(mode), n), 0xA5, dtype=np.uint8)
    ok = np.full(n, 9, dtype=np.uint8)
    if mode == "stage":
        return packed, ok, ted.BatchVerifier._stage_py(items, start, n, packed, ok), None
    rejects = ted.BatchVerifier._stage_py_raw(items, start, n, packed, ok)
    flagged = int(packed[tsha.ROW_FLAG].sum()) if mode == "stage_rows" else None
    return packed, ok, rejects, flagged


def _refcounts(items):
    return [sys.getrefcount(o) for t in items for o in (t, *t)]


@pytest.mark.parametrize("slots", [3, 4, "named"])
@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("count", [0, 1, 63, 64, 65, 4097])
@pytest.mark.parametrize("mode", MODES)
def test_c_stage_equals_the_python_stage(mode, count, threads, slots):
    """The same bytes, verdicts, rejects and flag-1 count as the Python
    stage over items[5:5 + count], three padding lanes zeroed past them,
    no lane staged with the GIL held, and every reference given back."""
    items = _lanes(count + 7, random.Random(f"{count}-{slots}"), slots)
    before = _refcounts(items)
    out, ok, rejects, flagged, gil = _c_stage(mode, items, 5, count, threads, stride=count + 3)
    assert _refcounts(items) == before
    p_out, p_ok, p_rejects, p_flagged = _py_stage(mode, items, 5, count)
    np.testing.assert_array_equal(out[:, :count], p_out)
    assert not out[:, count:].any()
    np.testing.assert_array_equal(ok, p_ok)
    assert rejects == p_rejects == count - int(ok.sum())
    assert flagged == p_flagged and gil == 0
    if count >= 64:
        assert 0 < rejects < count
        if mode != "stage":  # single-block (flag 1) and host-hashed (flag 0) lanes
            flags = out[tsha.ROW_FLAG, :count][ok.astype(bool)]
            assert flags.any() and not flags.all()


@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("slot", [0, 1, 2], ids=["pk", "msg", "sig"])
@pytest.mark.parametrize("mode", MODES)
def test_a_bytes_subclass_is_staged_as_bytes(mode, slot, threads):
    """A bytes subclass in any slot is staged as the same bytes would be,
    after the GIL is back, and counted as a lane staged with the GIL
    held; the references are given back."""
    n = 4097
    plain = _lanes(n, random.Random(7 + slot))
    lanes = (0, 63, 64, 2048, n - 1)
    mixed = list(plain)
    for i in lanes:
        t = list(mixed[i])
        t[slot] = SubBytes(t[slot])
        mixed[i] = tuple(t)
    before = _refcounts(mixed)
    got = _c_stage(mode, mixed, 0, n, threads)
    assert _refcounts(mixed) == before
    want = _c_stage(mode, plain, 0, n, threads)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:4] == want[2:4]
    assert (got[4], want[4]) == (len(lanes), 0)


def _bad(kind, t):
    """Lane tuple t made into one the stage refuses."""
    if kind == "bytearray":
        return (t[0], bytearray(t[1]), t[2])
    if kind == "str":
        return (t[0], t[1], t[2].hex())
    if kind == "short_tuple":
        return t[:2]
    return list(t)  # "list": not a tuple


@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("kind", ["bytearray", "str", "short_tuple", "list"])
@pytest.mark.parametrize("mode", MODES)
def test_a_lane_that_is_not_bytes_raises(mode, kind, threads):
    """A bytearray or a str slot raises TypeError once the pass is done, and
    then out and ok hold zeros; a short tuple or a list raises before the
    pass and leaves both as they were.  The message is the stage's, and
    every reference is given back."""
    n = 4097
    items = _lanes(n, random.Random(11))
    for i in (70, 3000):
        items[i] = _bad(kind, items[i])
    rows = _rows(mode)
    out = np.full((n, rows) if mode == "stage_rows" else (rows, n), 0xA5, dtype=np.uint8)
    ok = np.full(n, 9, dtype=np.uint8)
    before = _refcounts(items)
    msg = {"bytearray": SLOT_ERROR.format("bytearray"), "str": SLOT_ERROR.format("str")}
    with pytest.raises(TypeError) as e:
        getattr(native.load_sighash(), mode)(items, 0, n, out, ok, ted._BLACKLIST, threads)
    assert str(e.value) == msg.get(kind, TUPLE_ERROR)
    assert _refcounts(items) == before
    if kind in msg:
        assert not out.any() and not ok.any()
    else:
        assert (out == 0xA5).all() and (ok == 9).all()


@pytest.mark.parametrize("first", ["slot", "tuple"])
@pytest.mark.parametrize("mode", MODES)
def test_the_first_bad_lane_names_the_error(mode, first):
    """The first refused lane in lane order names the error, whether its
    fault is a slot or the tuple, as when every slot was checked before
    the pass."""
    items = _lanes(200, random.Random(13))
    kinds = ("bytearray", "short_tuple") if first == "slot" else ("short_tuple", "bytearray")
    for i, kind in zip((40, 150), kinds):
        items[i] = _bad(kind, items[i])
    before = _refcounts(items)
    rows = _rows(mode)
    with pytest.raises(TypeError) as e:
        getattr(native.load_sighash(), mode)(items, 0, 200, np.zeros(rows * 200, dtype=np.uint8),
                                             np.zeros(200, dtype=np.uint8), ted._BLACKLIST, 1)
    assert str(e.value) == (SLOT_ERROR.format("bytearray") if first == "slot" else TUPLE_ERROR)
    assert _refcounts(items) == before


def _fake_device_hash_kernel(p, signed=None):
    """A fast stand-in for the plain device-hash pair."""
    rows = p.numpy()
    return torch.from_numpy(((rows[0] ^ rows[96]) & 1) == 0)


@pytest.mark.parametrize("native_hash", [True, False], ids=["c_stage", "python_stage"])
def test_host_hash_span_counts_the_gil_lanes(monkeypatch, native_hash):
    """``ed25519.host_hash`` carries ``gil_lanes``: 0 for a call of exact
    bytes and one a subclass lane in the C stage, every lane in the Python
    stage; the verdicts are those of the same bytes."""
    from stellar_tpu_torch.trace import Tracer

    monkeypatch.setattr(ted, "_verify_packed_device_hash", _fake_device_hash_kernel)
    plain = _lanes(24, random.Random(17))
    mixed = list(plain)
    mixed[3] = (SubBytes(plain[3][0]), *plain[3][1:])
    mixed[20] = (*plain[20][:2], SubBytes(plain[20][2]))
    counts, verdicts = [], []
    for items in (plain, mixed):
        tracer = Tracer(ring_size=1024)
        bv = ted.BatchVerifier(device="cpu", max_batch=8, device_hash=True, tracer=tracer,
                               native_hash=native_hash)
        verdicts.append(bv.verify(items))
        counts.append([s.attrs["gil_lanes"] for s in sorted(tracer.spans(), key=lambda s: s.start)
                       if s.name == "ed25519.host_hash"])
    assert verdicts[0] == verdicts[1] and any(verdicts[0])
    assert counts == ([[0, 0, 0], [1, 0, 1]] if native_hash else [[8, 8, 8]] * 2)
