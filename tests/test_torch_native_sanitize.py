"""The port's C engines under AddressSanitizer and UndefinedBehaviorSanitizer.

``STELLAR_TPU_SANITIZE="address,undefined"`` builds the five engines
(``sighash``, ``cxdrpack``, ``applycore``, ``bucketmerge``, ``halfagg``)
into separate sanitized artifacts in the port's build directory, and the
child script below runs hostile and truncated inputs through each of them
in a subprocess with the sanitizer runtimes preloaded: any out-of-bounds
access or undefined behaviour aborts it.  The same script runs once more
on the normal builds, and every output must equal: a sanitized build
computes what the shipped one does.  The port's twin of
``tests/test_native_build.py::test_sanitized_build_differentials`` (whose
``sighash.c`` has two test hooks that the port's lacks: the port's script
runs ``stage``, ``stage_raw``, ``stage_rows``, ``sha256_batch`` and
``bucket_hash_frames``).  The C stage reads each lane's bytes through its
tuple with the GIL released, so the script also gives it bytes-subclass and
refused lanes, and a list that another thread rebinds during the call; the
sanitized child allocates objects with ``malloc``, so that reading a freed
one is caught.

The script imports no torch (``ref25519`` is loaded by file), so it needs
only the toolchain.  Skips, with the reason, where the toolchain cannot
link the sanitizers or does not name their shared runtimes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODE = "address,undefined"
ENGINES = ("bucketmerge", "cxdrpack", "sighash", "halfagg", "applycore")

_CHILD = r"""
import base64, hashlib, importlib.util, json, os, random, shutil, struct, sys, tempfile, threading

import stellar_tpu_torch.native as native

spec = importlib.util.spec_from_file_location(
    "ref25519", os.path.join(os.path.dirname(native.__file__), "..", "ops", "ref25519.py"))
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)


def dig(*parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode() if not isinstance(p, (bytes, bytearray)) else bytes(p))
    return h.hexdigest()


def outcome(fn, *args):
    # a value, or the name of the exception a hostile input raised
    try:
        return ("ok", dig(fn(*args)))
    except (ValueError, TypeError, OverflowError, IndexError) as e:
        return ("raised", type(e).__name__)
    except Exception as e:
        if type(e).__name__ == "XdrError":
            return ("raised", "XdrError")
        raise


rng = random.Random(20261017)
out = {"mode": native.sanitize_mode(), "artifacts": {}}


def frames(n, spill=False):
    buf = bytearray()
    for i in range(n):
        body = bytes(rng.randrange(256) for _ in range(rng.choice((0, 1, 55, 56, 96, 120, 300))))
        buf += struct.pack(">I", 0x80000000 | len(body)) + body
    return bytes(buf)


# -- bucketmerge: file hashes and merges over framed, truncated and garbage files
good = frames(60)
files = {
    "good": good, "truncated_body": good[:-7], "truncated_header": good + b"\x80\x00",
    "no_mark": struct.pack(">I", 12) + b"x" * 12, "oversized": b"\xff\xff\xff\xff" + b"y" * 8,
    "garbage": bytes(rng.randrange(256) for _ in range(999)), "empty": b"",
}
tmp = tempfile.mkdtemp(prefix="san_child_")
paths = {}
for name, data in files.items():
    paths[name] = os.path.join(tmp, name)
    with open(paths[name], "wb") as f:
        f.write(data)
bm = {}
for name, path in sorted(paths.items()):
    bm[name] = [native.sha256_file(path), native.bucket_hash_v2_file(path)]
    assert bm[name][0] == hashlib.sha256(files[name]).digest()
    bm[name] = [b.hex() if isinstance(b, bytes) else [b[0].hex(), b[1]] if b else None for b in bm[name]]
for a, b in (("good", "garbage"), ("truncated_body", "good"), ("no_mark", "oversized"),
             ("empty", "empty")):
    for fn in (native.merge_files, native.merge_files_v2):
        res = fn(paths[a], paths[b], [paths["garbage"]], True, os.path.join(tmp, "merged"))
        bm[f"{fn.__name__}:{a}:{b}"] = None if res is None else [res[0].hex(), res[1]]
out["bucketmerge"] = dig(sorted(bm.items()))
shutil.rmtree(tmp)
lib = native._bucketmerge()
out["artifacts"]["bucketmerge"] = lib._name

# -- cxdrpack: pack / unpack round trips, truncated tails, garbage
from stellar_tpu_torch.xdr.arbitrary import arbitrary_of
from stellar_tpu_torch.xdr.base import XdrError, _cspec_of
from stellar_tpu_torch.xdr.entries import LedgerEntry

mod = native.load_cxdrpack()
assert mod is not None, "cxdrpack did not build"
out["artifacts"]["cxdrpack"] = mod.__file__
defs = []
root = _cspec_of(LedgerEntry._codec, defs, {})
prog = mod.compile(defs, root, XdrError)
cx = []
for i in range(25):
    v = arbitrary_of(LedgerEntry, 8, random.Random(i))
    octets = mod.pack(prog, v)
    assert mod.unpack(prog, octets).to_xdr() == octets
    cx.append(dig(octets))
    for cut in (1, 4, len(octets) // 2):
        cx.append(outcome(lambda b: mod.unpack(prog, b).to_xdr(), octets[: len(octets) - cut]))
    cx.append(outcome(lambda b: mod.unpack(prog, b).to_xdr(), octets + b"\x00\x00\x00\x07"))
cx.append(outcome(lambda b: mod.unpack(prog, b).to_xdr(), b"\xff" * 64))
cx.append(outcome(lambda b: mod.unpack(prog, b).to_xdr(), b""))
out["cxdrpack"] = dig(cx)

# -- sighash: stage / stage_raw / stage_rows over hostile lanes, SHA-256 batches, frame walks
sig_mod = native.load_sighash()
out["artifacts"]["sighash"] = sig_mod.__file__
bl = b"".join(ref.small_order_blacklist())
B = ref.base_point()
items = [(b"\x42" + b"\x24" * 31, b"known msg", b"\x99" * 32 + b"\x01" + b"\x00" * 31)]
for i in range(79):
    a = rng.randrange(1, ref.L)
    pk = ref.compress(ref.scalar_mult(a, B))
    msg = bytes(rng.randrange(256) for _ in range(rng.choice((0, 1, 47, 48, 111, 112, 200))))
    sig = bytes(rng.randrange(256) for _ in range(64))
    cls = i % 8
    if cls == 1:
        sig = sig[:32] + b"\xff" * 32  # s >= L
    elif cls == 2:
        pk = rng.choice(ref.small_order_blacklist())
    elif cls == 3:
        pk = (ref.P + rng.randrange(19)).to_bytes(32, "little")  # y >= p
    elif cls == 4:
        pk = bytes(rng.randrange(256) for _ in range(32))
    items.append((pk, msg, sig))
sh = []
for stage, rows in ((sig_mod.stage, 128), (sig_mod.stage_raw, 160), (sig_mod.stage_rows, 160)):
    for start, count in ((0, 80), (3, 41), (79, 1)):
        buf = bytearray(rows * count)
        ok = bytearray(count)
        rejects = stage(items, start, count, buf, ok, bl, 0)
        sh.append((rejects, dig(buf), dig(ok)))
    buf = bytearray(rows * 47)  # seven padding lanes past the 40 staged
    sh.append((stage(items, 5, 40, buf, bytearray(47), bl, 1), dig(buf)))
    for bad in ([(b"short", b"m", b"s")], [(b"\x00" * 32, b"m")], [(b"\x00" * 32, "str", b"\x00" * 64)]):
        sh.append(outcome(stage, bad, 0, 1, bytearray(rows), bytearray(1), bl, 0))
    sh.append(outcome(stage, items, 70, 20, bytearray(rows * 20), bytearray(20), bl, 0))
    sh.append(outcome(stage, items, 0, 8, bytearray(rows * 4), bytearray(8), bl, 0))


# a bytes subclass in each slot (staged once the GIL is back), then a
# bytearray, a str and a short tuple among 2,400 lanes (pool workers on)
class SubBytes(bytes):
    pass


wide = [items[i % 80] for i in range(2400)]
for stage, rows in ((sig_mod.stage, 128), (sig_mod.stage_raw, 160), (sig_mod.stage_rows, 160)):
    for slot in range(3):
        lanes = [tuple(SubBytes(x) if k == slot else x for k, x in enumerate(t)) if i % 97 == 5
                 else t for i, t in enumerate(wide)]
        buf, ok, stamps = bytearray(rows * 2400), bytearray(2400), bytearray(48)
        sh.append((stage(lanes, 0, 2400, buf, ok, bl, 0, stamps), dig(buf), dig(ok),
                   int.from_bytes(stamps[40:], "little")))
    for bad in ((b"\x00" * 32, bytearray(b"m"), b"\x00" * 64), (b"\x00" * 32, b"m", "s" * 64),
                (b"\x00" * 32, b"m")):
        lanes = wide[:1500] + [bad] + wide[1500:]
        buf, ok = bytearray(b"\xa5" * rows * 2401), bytearray(b"\x09" * 2401)
        sh.append((outcome(stage, lanes, 0, 2401, buf, ok, bl, 0), dig(buf), dig(ok)))


# another thread rebinds the list's slots to fresh tuples of other bytes
# while stage_rows runs over it, dropping the tuples the call was given:
# the list's slots are their only other references.  It rebinds from the
# last lane down, the pass reads from the first up, so they meet.  The
# staged bytes are those of the tuples the list held at the call.
def fresh(t):
    return tuple(bytes(bytearray(x)) for x in t)

other = fresh(items[1])
prev_interval = sys.getswitchinterval()
sys.setswitchinterval(0.5)  # the other thread runs while the stage lets go of the GIL
for rnd in range(3):
    lanes = [fresh(items[(i * 7 + rnd) % 80]) for i in range(32768)]
    want_buf, want_ok = bytearray(160 * 32768), bytearray(32768)
    want = sig_mod.stage_rows([fresh(t) for t in lanes], 0, 32768, want_buf, want_ok, bl, 1)
    go, stop = threading.Event(), threading.Event()

    def rebind(lanes=lanes, go=go, stop=stop):
        go.wait()
        i = 0
        while not stop.is_set():
            lanes[32767 - i % 32768] = (other[0], other[1], bytes(bytearray(other[2])))
            i += 1

    th = threading.Thread(target=rebind)
    th.start()
    buf, ok = bytearray(160 * 32768), bytearray(32768)
    go.set()
    got = sig_mod.stage_rows(lanes, 0, 32768, buf, ok, bl, 1)
    stop.set()
    th.join()
    assert (got, buf, ok) == (want, want_buf, want_ok), rnd
    sh.append((got, dig(buf), dig(ok)))
sys.setswitchinterval(prev_interval)
msgs = [bytes(rng.randrange(256) for _ in range(n)) for n in (0, 1, 55, 56, 63, 64, 65, 119, 120, 1000)]
dout = bytearray(32 * len(msgs))
sig_mod.sha256_batch(msgs, dout)
assert bytes(dout[:32]) == hashlib.sha256(b"").digest()
sh.append(dig(dout))
sh.append(outcome(sig_mod.sha256_batch, msgs, bytearray(31)))
sh.append(outcome(sig_mod.sha256_batch, [b"x", 7], bytearray(64)))
for name in sorted(files):
    sh.append((name, outcome(sig_mod.bucket_hash_frames, files[name])))
out["sighash"] = dig(sh)

# -- halfagg: decompress, msm, msm_ext, torsion_free on hostile points
agg_mod = native.load_halfagg()
assert agg_mod is not None, "halfagg did not build"
out["artifacts"]["halfagg"] = agg_mod.__file__
pts = [ref.compress(B)] + [bytes(rng.randrange(256) for _ in range(32)) for _ in range(40)]
pts += [b"\x00" * 32, b"\x01" + b"\x00" * 31, b"\xff" * 32] + list(ref.small_order_blacklist())[:3]
okf, ext = agg_mod.decompress(b"".join(pts))
assert okf[0] == 1
good_ext = [ext[i * 160 : (i + 1) * 160] for i in range(len(pts)) if okf[i]]
scalars = b"".join(rng.randrange(ref.L).to_bytes(32, "little") for _ in good_ext)
ha = [dig(okf), dig(ext), dig(agg_mod.msm_ext(b"".join(good_ext), scalars)),
      dig(agg_mod.torsion_free(b"".join(good_ext)))]
good_pts = b"".join(p for p, f in zip(pts, okf) if f)
ha.append(outcome(agg_mod.msm, good_pts, scalars))
ha.append(outcome(agg_mod.msm_ext, b"\xff" * 160, b"\x01" + b"\x00" * 31))
for bad in (b"\x01" * 31, b"\x01" * 33):
    ha.append(outcome(agg_mod.msm, bad, b"\x00" * 32))
    ha.append(outcome(agg_mod.decompress, bad))
ha.append(outcome(agg_mod.torsion_free, b"\x00" * 159))
out["halfagg"] = dig(ha)

# -- applycore: batch row encode on ragged and hostile rows
apl_mod = native.load_applycore()
assert apl_mod is not None, "applycore did not build"
out["artifacts"]["applycore"] = apl_mod.__file__
rows = [(bytes(rng.randrange(256) for _ in range(32)),
         bytes(rng.randrange(256) for _ in range(rng.randrange(0, 400))), b"", b"\xff" * 3)
        for _ in range(40)]
enc = apl_mod.encode_history_rows(rows)
for (t, b, r, m), (ht, bb, br, bm_) in zip(rows, enc):
    assert ht == t.hex() and bb == base64.b64encode(b).decode() and bm_ == "////"
ap = [dig(enc)]
for bad in ([(b"x",)], [("s", b"", b"", b"")], "nope", [(b"", b"", b"", b"")], []):
    ap.append(outcome(apl_mod.encode_history_rows, bad))
out["applycore"] = dig(ap)

print("SAN_RESULT " + json.dumps(out, sort_keys=True))
"""


def _sanitizer_ready():
    """(preload libs, None) or (None, the reason to skip)."""
    from stellar_tpu_torch import native

    libs = native.sanitizer_preload_libs()
    if libs is None:
        return None, "the toolchain does not name libasan/libubsan shared runtimes"
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.c")
        with open(src, "w") as f:
            f.write("int probe(int x) { return x + 1; }\n")
        try:
            native._compile_so(src, os.path.join(d, "probe.so"), (f"-fsanitize={MODE}",))
        except RuntimeError:
            return None, f"cc cannot link -fsanitize={MODE}"
    return libs, None


def _drive(env_extra):
    env = {k: v for k, v in os.environ.items() if k not in ("STELLAR_TPU_SANITIZE", "LD_PRELOAD")}
    env.update(PYTHONPATH=REPO, **env_extra)
    p = subprocess.run(
        [sys.executable, "-c", _CHILD], capture_output=True, text=True,
        timeout=600, env=env, cwd=REPO,
    )
    assert p.returncode == 0, (
        f"child failed rc={p.returncode} ({env_extra.get('STELLAR_TPU_SANITIZE', 'normal')})\n"
        f"--- stdout ---\n{p.stdout[-4000:]}\n--- stderr ---\n{p.stderr[-6000:]}"
    )
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("SAN_RESULT ")][-1]
    return json.loads(line[len("SAN_RESULT "):])


@pytest.fixture(scope="module")
def runs():
    libs, reason = _sanitizer_ready()
    if libs is None:
        pytest.skip(reason)
    normal = _drive({})
    sanitized = _drive({
        "STELLAR_TPU_SANITIZE": MODE,
        "LD_PRELOAD": ":".join(libs),
        # leak accounting means nothing for a short child under CPython's
        # allocator; any real error aborts
        "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
        # objects on malloc, so that the sanitizer sees a freed one read
        "PYTHONMALLOC": "malloc",
        "UBSAN_OPTIONS": "halt_on_error=1,print_stacktrace=1",
    })
    return normal, sanitized


@pytest.mark.parametrize("engine", ENGINES)
def test_sanitized_engine_equals_the_normal_build(runs, engine):
    normal, sanitized = runs
    assert sanitized[engine] == normal[engine], engine


def test_sanitized_builds_are_separate_artifacts(runs):
    from stellar_tpu_torch import native

    normal, sanitized = runs
    assert normal["mode"] is None and sanitized["mode"] == MODE
    build = os.path.realpath(native.BUILD_DIR)
    for engine in ENGINES:
        san, plain = sanitized["artifacts"][engine], normal["artifacts"][engine]
        assert ".san-address-undefined-" in os.path.basename(san), san
        assert ".san-" not in os.path.basename(plain), plain
        for path in (san, plain):
            assert os.path.dirname(os.path.realpath(path)) == build, path


def test_sanitize_mode_flags(monkeypatch):
    """The mode's flags: the sanitizer set, -O1 in place of -O3, and a stem
    that names the exact set."""
    from stellar_tpu_torch import native

    monkeypatch.delenv("STELLAR_TPU_SANITIZE", raising=False)
    assert native.sanitize_mode() is None
    assert native._c_flags(("-pthread",), ("-O3",)) == ("-pthread", "-O3")
    assert native._stem("_halfagg") == "_halfagg"
    monkeypatch.setenv("STELLAR_TPU_SANITIZE", "address")
    assert native._stem("_halfagg") == "_halfagg.san-address"
    monkeypatch.setenv("STELLAR_TPU_SANITIZE", MODE)
    flags = native._c_flags(("-pthread",), ("-O3",))
    assert flags == ("-pthread", f"-fsanitize={MODE}", "-fno-sanitize-recover=all", "-g", "-O1")
    assert native._stem("_halfagg") == "_halfagg.san-address-undefined"
