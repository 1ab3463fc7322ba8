"""The C host stage of the verify plane (``sighash.c``), built on first use.

``sighash.c`` is a CPython extension: the libsodium strict-input gate,
h = SHA-512(R‖A‖M) mod L, and the packed transposed ``(128, stride)``
uint8 staging layout, in one GIL-released C pass over a chunk.  Its
``stage`` takes writable buffers (``w*``), so it fills a pinned torch
tensor in place through ``tensor.numpy()``.

The shared object is compiled with the system C compiler into the port's
build directory (``stellar_tpu_torch/_build/``, gitignored), under a name
keyed by a hash of the source and the flags, so an edited source is
rebuilt and a stale object is never loaded.
"""

from __future__ import annotations

import hashlib
import os
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
    (``stage(items, start, count, out, ok, blacklist, threads)``).
    Builds on first call (needs -pthread for the internal worker pool);
    a failed build raises."""
    global _sighash_mod
    with _sighash_lock:
        if _sighash_mod is None:
            _sighash_mod = _load_extension("_sighash", _SIGHASH_SRC, ("-pthread",))
        return _sighash_mod
