"""The port's native builds: the C host stage (``sighash.c``) and the CUDA
kernel libraries (``csrc/*.cu``), each built on first use.

``sighash.c`` is a CPython extension: the libsodium strict-input gate,
h = SHA-512(R‖A‖M) mod L, and the packed transposed ``(128, stride)``
uint8 staging layout (``(160, stride)`` with raw messages for the
device-hash path), in one GIL-released C pass over a chunk; and the
batched SHA-256 of the bucket-hash plane.  Its ``stage``/``stage_raw``
take writable buffers (``w*``), so they fill a pinned torch tensor in
place through ``tensor.numpy()``.

Each shared object is compiled (the system C compiler; ``nvcc`` for
``sm_90a``) into the port's build directory (``stellar_tpu_torch/_build/``,
gitignored), under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and a stale object is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Sequence

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
    """Build (unless a build of this exact source exists) and load a
    CPython extension by path.  The unresolved CPython symbols bind into
    the running interpreter at dlopen time, so no libpython link is
    needed."""
    import importlib.machinery
    import importlib.util
    import sysconfig

    flags = (f"-I{sysconfig.get_paths()['include']}", *extra_flags)
    so = build_path([src], flags, name, ".so")
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
    (``stage``/``stage_raw(items, start, count, out, ok, blacklist,
    threads)``) and SHA-256 batch (``sha256_batch``,
    ``bucket_hash_frames``).  Builds on first call (needs -pthread for the
    internal worker pool); a failed build raises."""
    global _sighash_mod
    with _sighash_lock:
        if _sighash_mod is None:
            _sighash_mod = _load_extension("_sighash", _SIGHASH_SRC, ("-pthread",))
        return _sighash_mod
