"""Wrapper of the hand-written Hopper SHA-512-mod-L kernel (``csrc/sha512_h.cu``).

The kernel replaces the TPU kernel ``stellar_tpu/ops/sha512.py::
sha512_pallas``.  It is built with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, loaded with ``ctypes``, at first use
(``native.build_cuda_library``).

- ``hash_in_place(p)`` — the verify plane's call: writes h into rows
  96:128 of the packed (160, N) tensor itself, so ``p[:128]`` is then the
  verify kernel's (128, N) input.
- ``h_rows(p)`` — the same function into a new (32, N) uint8 tensor (the
  tests and chip_smoke.py's comparison).
- ``launch_noop(device)`` — an empty kernel on the current stream, the
  floor of one launch when timing (not counted in ``launches``).

On a CPU tensor both run the plain PyTorch version
(``ops/sha512.py::h_rows_from_packed``); on a CUDA tensor they launch the
kernel or raise.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import native
from . import sha512

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "sha512_h.cu")
_STEM = "libsha512_h"

# kernel launches since import (or since the caller last reset it to 0)
launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None


def library_path() -> str:
    return native.cuda_library_path(SOURCE, _STEM)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library; a failed
    build raises with the compiler's output."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(native.build_cuda_library(SOURCE, _STEM))
        lib.sha512_h_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.sha512_h_launch.restype = ctypes.c_int
        lib.sha512_h_noop_launch.argtypes = [ctypes.c_void_p]
        lib.sha512_h_noop_launch.restype = ctypes.c_int
        lib.sha512_h_error_string.argtypes = [ctypes.c_int]
        lib.sha512_h_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(p: torch.Tensor) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"sha512_h: unsupported device {p.device}")
    if p.dtype != torch.uint8 or p.dim() != 2 or p.shape[0] != sha512.DH_ROWS:
        raise ValueError(
            f"sha512_h wants a (160, N) uint8 tensor, got {tuple(p.shape)} {p.dtype}"
        )
    if not p.is_contiguous():
        raise ValueError("sha512_h wants a contiguous tensor")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.sha512_h_error_string(err).decode()} ({err})")


def launch_noop(device) -> None:
    """Launch the library's empty kernel on ``device``'s current stream."""
    lib = load_library()
    _raise_on(lib, lib.sha512_h_noop_launch(torch.cuda.current_stream(device).cuda_stream), "noop kernel")


def _launch(p: torch.Tensor, out: torch.Tensor) -> None:
    global launches
    n = p.shape[1]
    if n == 0:
        return
    lib = load_library()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    _raise_on(lib, lib.sha512_h_launch(p.data_ptr(), out.data_ptr(), n, stream), "sha512_h kernel")
    with _count_lock:
        launches += 1


def h_rows(p: torch.Tensor) -> torch.Tensor:
    """(160, N) uint8 packed chunk -> new (32, N) uint8 h rows."""
    if p.device.type == "cpu":
        return sha512.h_rows_from_packed(p).to(torch.uint8)
    _check(p)
    out = torch.empty((32, p.shape[1]), dtype=torch.uint8, device=p.device)
    _launch(p, out)
    return out


def hash_in_place(p: torch.Tensor) -> None:
    """Write h into rows 96:128 of the (160, N) uint8 packed chunk ``p``."""
    if p.device.type == "cpu":
        p[96:128] = sha512.h_rows_from_packed(p).to(torch.uint8)
        return
    _check(p)
    _launch(p, p[96:128])
