"""Wrapper of the hand-written Hopper SHA-256 kernel (``csrc/sha256_frames.cu``).

The kernel replaces the TPU kernel ``stellar_tpu/ops/sha256.py::
sha256_pallas``.  It is built with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, loaded with ``ctypes``, at first use
(``native.build_cuda_library``).

``digest_rows(p, nblocks)`` on CPU tensors runs the plain PyTorch version
(``ops/sha256.py::sha256_rows_from_packed``); on CUDA tensors it launches
the kernel or raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import native
from . import launch_device, sha256

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "sha256_frames.cu")
_STEM = "libsha256_frames"

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
        lib.sha256_frames_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.sha256_frames_launch.restype = ctypes.c_int
        lib.sha256_frames_error_string.argtypes = [ctypes.c_int]
        lib.sha256_frames_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def digest_rows(p: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """(max_blocks * 64, N) uint8 padded columns + (N,) int32 block counts
    -> (32, N) uint8 digest rows."""
    global launches
    if p.device.type == "cpu":
        return sha256.sha256_rows_from_packed(p, nblocks).to(torch.uint8)
    if p.device.type != "cuda":
        raise ValueError(f"sha256_frames: unsupported device {p.device}")
    if p.dtype != torch.uint8 or p.dim() != 2 or p.shape[0] == 0 or p.shape[0] % 64:
        raise ValueError(
            f"sha256_frames wants a (max_blocks*64, N) uint8 tensor, got "
            f"{tuple(p.shape)} {p.dtype}"
        )
    rows, n = p.shape
    if nblocks.dtype != torch.int32 or tuple(nblocks.shape) != (n,) or nblocks.device != p.device:
        raise ValueError("sha256_frames wants (N,) int32 block counts on the same device")
    if not (p.is_contiguous() and nblocks.is_contiguous()):
        raise ValueError("sha256_frames wants contiguous tensors")
    out = torch.empty((32, n), dtype=torch.uint8, device=p.device)
    if n == 0:
        return out
    lib = load_library()
    with launch_device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sha256_frames_launch(
            p.data_ptr(), nblocks.data_ptr(), out.data_ptr(), n, rows // 64, stream
        )
    if err != 0:
        raise RuntimeError(
            f"sha256_frames kernel launch failed: "
            f"{lib.sha256_frames_error_string(err).decode()} ({err})"
        )
    with _count_lock:
        launches += 1
    return out
