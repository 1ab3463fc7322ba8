"""The port's native builds: the C host stage (``sighash.c``), the node's C
engines (``bucketmerge.c``, ``cxdrpack.c``, ``applycore.c``, ``halfagg.c``,
copies of the JAX package's) and the CUDA kernel libraries (``csrc/*.cu``),
each built on first use.

``sighash.c`` is a CPython extension: the libsodium strict-input gate,
h = SHA-512(R‖A‖M) mod L, and the packed transposed ``(128, stride)``
uint8 staging layout (``(160, stride)`` with raw messages for the
device-hash path, or the same rows item-major, ``(stride, 160)``), in one
GIL-released C pass over a chunk; and the batched SHA-256 of the
bucket-hash plane.  Its ``stage``/``stage_raw``/``stage_rows`` take
writable buffers (``w*``), so they fill a pinned torch tensor in place
through ``tensor.numpy()``.

The node's engines keep the JAX package's contract: each loader returns
None (and the caller takes its pure-Python path, with the same bytes) when
the engine does not build.  ``bucketmerge.c`` is a plain C library behind
ctypes: the streaming bucket merge and the one-pass bucket file hashes
(``merge_files``, ``merge_files_v2``, ``sha256_file``,
``bucket_hash_v2_file``); ctypes releases the GIL for the call, so merges on
the worker pool never stall the main crank.  ``build_all`` builds every
one of them up front, so no build lands inside a node's first close.

Each shared object is compiled (the system C compiler; ``nvcc`` for
``sm_90a``) into the port's build directory (``stellar_tpu_torch/_build/``,
gitignored), under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and a stale object is never loaded.  A build
writes a per-process temporary name and renames it into place, so
concurrent first builds in sibling processes do not race.

Sanitizer build mode: ``STELLAR_TPU_SANITIZE=<list>`` (e.g.
``"address,undefined"``) builds every C engine with ``-fsanitize=<list>
-fno-sanitize-recover=all -g -O1`` (and without ``-O3``) into a separate
artifact whose name carries the set (``_sighash.san-address-undefined-…``),
so the normal build is never replaced.  A sanitized CPython extension loads
only into an interpreter with the sanitizer runtime present: run it in a
subprocess with ``LD_PRELOAD`` set from ``sanitizer_preload_libs()``
(``tests/test_torch_native_sanitize.py``).  The CUDA builds ignore the mode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_SIGHASH_SRC = os.path.join(_HERE, "sighash.c")


def build_path(srcs: Sequence[str], flags: Sequence[str], stem: str, ext: str) -> str:
    """Path in the build directory for an artifact of ``srcs`` built with
    ``flags``: the name carries a hash of both, so any change rebuilds."""
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{ext}")


# nvcc flags of every CUDA kernel library: Hopper's sm_90a, a plain C entry
# point (no PyTorch headers), and the ptxas report (registers, spills)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def cuda_library_path(source: str, stem: str) -> str:
    return build_path([source], NVCC_FLAGS, stem, ".so")


def build_cuda_library(source: str, stem: str) -> str:
    """Build the CUDA source into a shared library in the build directory
    (once per source hash) and return its path.  nvcc's output, with the
    ptxas report, is kept beside the library as ``.log``; a failed build
    raises with the compiler's output."""
    so = cuda_library_path(source, stem)
    if os.path.exists(so):
        return so
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {source} cannot be built")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, source],
        capture_output=True,
        text=True,
        timeout=600,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}) on {source}:\n{r.stderr[-4000:]}")
    with open(so[:-3] + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so


# -- sanitizer build mode of the C engines ------------------------------------


def sanitize_mode() -> Optional[str]:
    """The sanitizer set of ``STELLAR_TPU_SANITIZE``, or None."""
    return os.environ.get("STELLAR_TPU_SANITIZE") or None


def _san_flags() -> tuple:
    mode = sanitize_mode()
    if not mode:
        return ()
    return (f"-fsanitize={mode}", "-fno-sanitize-recover=all", "-g", "-O1")


def _c_flags(extra: Sequence[str] = (), optimize: Sequence[str] = ()) -> tuple:
    """An engine's compiler flags after the default -O2: ``optimize``
    (e.g. -O3) only in a normal build — it would out-rank the sanitizer's
    deliberate -O1 — and the sanitizer's flags in a sanitizer build."""
    return (*extra, *(_san_flags() or optimize))


def _stem(name: str) -> str:
    """An engine's artifact stem: its name, plus the exact sanitizer set in
    a sanitizer build (an address-only build is never reused for an
    address,undefined run)."""
    mode = sanitize_mode()
    if not mode:
        return name
    return f"{name}.san-{re.sub(r'[^A-Za-z0-9]+', '-', mode).strip('-')}"


def sanitizer_preload_libs(kinds: Sequence[str] = ("asan", "ubsan")) -> Optional[List[str]]:
    """Paths of the sanitizer runtimes to ``LD_PRELOAD`` into a subprocess
    that loads sanitized engines, or None where the toolchain does not name
    them as shared libraries (clang's static runtimes, no toolchain)."""
    out = []
    for kind in kinds:
        path = None
        for cc in ("cc", "gcc", "clang"):
            try:
                r = subprocess.run(
                    [cc, f"-print-file-name=lib{kind}.so"],
                    capture_output=True, timeout=30, text=True,
                )
            except (OSError, subprocess.TimeoutExpired):
                continue
            cand = r.stdout.strip()
            if r.returncode == 0 and os.sep in cand and os.path.exists(cand):
                path = cand
                break
        if path is None:
            return None
        out.append(path)
    return out


def _compile_so(src: str, so: str, extra_flags: Sequence[str] = ()) -> None:
    """Compile ``src`` into the shared object ``so``; raise on failure."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # per-process temp name: concurrent first-use builds in sibling
    # processes must not interleave writes into one file
    tmp = f"{so}.{os.getpid()}.tmp"
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", *extra_flags, "-o", tmp, src],
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, so)
            return
        errors.append(f"{cc}: {r.stderr.decode(errors='replace')[-2000:]}")
    try:
        os.unlink(tmp)
    except OSError:
        pass
    raise RuntimeError(f"building {src} failed:\n" + "\n".join(errors))


def _load_extension(name: str, src: str, extra_flags: Sequence[str] = ()):
    """Build (unless a build of this exact source and these flags exists)
    and load a CPython extension by path; ``extra_flags`` come from
    ``_c_flags``.  The unresolved CPython symbols bind into
    the running interpreter at dlopen time, so no libpython link is
    needed."""
    import importlib.machinery
    import importlib.util
    import sysconfig

    flags = (f"-I{sysconfig.get_paths()['include']}", *extra_flags)
    so = build_path([src], flags, _stem(name), ".so")
    if not os.path.exists(so):
        _compile_so(src, so, flags)
    loader = importlib.machinery.ExtensionFileLoader(name, so)
    spec = importlib.util.spec_from_file_location(name, so, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


_sighash_lock = threading.Lock()
_sighash_mod = None


def load_sighash():
    """The compiled batch gate + SHA-512-mod-L host stage
    (``stage``/``stage_raw``/``stage_rows(items, start, count, out, ok,
    blacklist, threads)``) and SHA-256 batch (``sha256_batch``,
    ``bucket_hash_frames``).  Builds on first call (needs -pthread for the
    internal worker pool); a failed build raises."""
    global _sighash_mod
    with _sighash_lock:
        if _sighash_mod is None:
            _sighash_mod = _load_extension("_sighash", _SIGHASH_SRC, _c_flags(("-pthread",)))
        return _sighash_mod


# -- the node's C engines -----------------------------------------------------

_BUCKETMERGE_SRC = os.path.join(_HERE, "bucketmerge.c")
_CXDR_SRC = os.path.join(_HERE, "cxdrpack.c")
_APPLYCORE_SRC = os.path.join(_HERE, "applycore.c")
_HALFAGG_SRC = os.path.join(_HERE, "halfagg.c")

_engine_lock = threading.Lock()
_engines: dict = {}  # name -> loaded module / CDLL, or None after a failed build


def _engine(name: str, load):
    with _engine_lock:
        if name not in _engines:
            try:
                _engines[name] = load()
            except (RuntimeError, ImportError, OSError):
                _engines[name] = None
        return _engines[name]


def _load_bucketmerge():
    flags = _c_flags()
    so = build_path([_BUCKETMERGE_SRC], flags, _stem("_bucketmerge"), ".so")
    if not os.path.exists(so):
        _compile_so(_BUCKETMERGE_SRC, so, flags)
    lib = ctypes.CDLL(so)
    lib.bucket_merge.restype = ctypes.c_int
    lib.bucket_merge.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char * 32,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.bucket_merge_v2.restype = ctypes.c_int
    lib.bucket_merge_v2.argtypes = lib.bucket_merge.argtypes
    lib.sha256_file.restype = ctypes.c_int
    lib.sha256_file.argtypes = [ctypes.c_char_p, ctypes.c_char * 32]
    lib.bucket_hash_v2_file.restype = ctypes.c_int
    lib.bucket_hash_v2_file.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char * 32,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    return lib


def _bucketmerge():
    return _engine("bucketmerge", _load_bucketmerge)


def available() -> bool:
    """True when the bucket merge engine builds and loads."""
    return _bucketmerge() is not None


def _merge(fn_name: str, old_path, new_path, shadow_paths, keep_dead, out_path):
    lib = _bucketmerge()
    if lib is None or len(shadow_paths) > 32:
        return None
    shadows = (ctypes.c_char_p * max(1, len(shadow_paths)))()
    for i, p in enumerate(shadow_paths):
        shadows[i] = p.encode()
    out_hash = (ctypes.c_char * 32)()
    out_count = ctypes.c_longlong(0)
    rc = getattr(lib, fn_name)(
        old_path.encode(),
        new_path.encode(),
        shadows,
        len(shadow_paths),
        1 if keep_dead else 0,
        out_path.encode(),
        out_hash,
        ctypes.byref(out_count),
    )
    if rc != 0:
        return None
    return bytes(out_hash), int(out_count.value)


def merge_files(
    old_path: str,
    new_path: str,
    shadow_paths: Sequence[str],
    keep_dead: bool,
    out_path: str,
) -> Optional[Tuple[bytes, int]]:
    """Merge two sorted bucket files into out_path: (content hash, record
    count), or None when the engine is unavailable or the merge failed
    (the caller falls back to Python).  A zero record count reports the
    hash of the empty stream."""
    return _merge("bucket_merge", old_path, new_path, shadow_paths, keep_dead, out_path)


def merge_files_v2(
    old_path: str,
    new_path: str,
    shadow_paths: Sequence[str],
    keep_dead: bool,
    out_path: str,
) -> Optional[Tuple[bytes, int]]:
    """merge_files with the v2 per-record-digest bucket hash
    (bucket/hashplane.py): the same record stream, another content hash."""
    return _merge("bucket_merge_v2", old_path, new_path, shadow_paths, keep_dead, out_path)


def sha256_file(path: str) -> Optional[bytes]:
    lib = _bucketmerge()
    if lib is None:
        return None
    out = (ctypes.c_char * 32)()
    if lib.sha256_file(path.encode(), out) != 0:
        return None
    return bytes(out)


def bucket_hash_v2_file(path: str) -> Optional[Tuple[bytes, int]]:
    """(v2 content hash, record count) of a bucket file, or None when the
    engine is unavailable or the file is unreadable or malformed (the
    caller re-walks it in Python for the verdict)."""
    lib = _bucketmerge()
    if lib is None:
        return None
    out = (ctypes.c_char * 32)()
    count = ctypes.c_longlong(0)
    if lib.bucket_hash_v2_file(path.encode(), out, ctypes.byref(count)) != 0:
        return None
    return bytes(out), int(count.value)


def load_cxdrpack():
    """The compiled C XDR pack interpreter, or None (pure-Python codec)."""
    return _engine("cxdrpack", lambda: _load_extension("_cxdrpack", _CXDR_SRC, _c_flags()))


def load_applycore():
    """The compiled parallel-apply host leg (``encode_history_rows``), or
    None (ledger/applysched.py encodes the rows in Python)."""
    return _engine(
        "applycore", lambda: _load_extension("_applycore", _APPLYCORE_SRC, _c_flags())
    )


def load_halfagg():
    """The compiled half-aggregation curve core (batch strict
    ``decompress``, Pippenger ``msm``/``msm_ext``), or None (the aggregate
    plane runs ref25519).  -O3 after the default -O2 (not in a sanitizer
    build): its field loops gain from the extra unrolling."""
    return _engine(
        "halfagg",
        lambda: _load_extension("_halfagg", _HALFAGG_SRC, _c_flags(optimize=("-O3",))),
    )


def build_all() -> dict:
    """Build and load the C host stage and every node engine now; returns
    {name: loaded} (False where an engine did not build)."""
    load_sighash()
    return {
        "sighash": True,
        "bucketmerge": available(),
        "cxdrpack": load_cxdrpack() is not None,
        "applycore": load_applycore() is not None,
        "halfagg": load_halfagg() is not None,
    }
