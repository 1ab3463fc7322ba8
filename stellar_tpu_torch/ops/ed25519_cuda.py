"""Wrapper of the hand-written Hopper verify kernel (``csrc/ed25519_verify.cu``).

The kernel replaces the TPU kernel ``stellar_tpu/ops/ed25519_pallas.py::
verify_kernel_pallas``.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point and loaded with ``ctypes`` — no
PyTorch headers, so the build takes seconds.  The build runs at first use,
from the sources in the repository only, into the gitignored build
directory, under a name keyed by a hash of the source and the flags.

``verify_packed(p)`` on a CPU tensor runs the plain PyTorch version
(``ops/ed25519.py::_verify_packed``); on a CUDA tensor it launches the
kernel or raises.  ``launches`` counts the kernel launches.  The kernel runs
each lane on a group of 4 threads (``geometry()``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .. import native
from . import ed25519 as ed
from . import launch_device
from . import ref25519 as ref

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "ed25519_verify.cu")
_STEM = "libed25519_verify"

# kernel launches since import (or since the caller last reset it to 0)
launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None
_consts: dict = {}


def library_path() -> str:
    return native.cuda_library_path(SOURCE, _STEM)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library; a failed
    build raises with the compiler's output.  The ptxas report (registers,
    spills) is kept beside the library as ``.log``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(native.build_cuda_library(SOURCE, _STEM))
        lib.ed25519_verify_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ed25519_verify_launch.restype = ctypes.c_int
        for fn in (lib.ed25519_const_ints, lib.ed25519_threads_per_lane, lib.ed25519_block_threads):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.ed25519_error_string.argtypes = [ctypes.c_int]
        lib.ed25519_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def geometry() -> tuple:
    """(threads a lane, threads a block) of the built kernel's launch."""
    lib = load_library()
    return lib.ed25519_threads_per_lane(), lib.ed25519_block_threads()


def _limbs25(v: int) -> list:
    """Python int < 2^255 -> the kernel's 10 limbs (radix 2^25.5)."""
    out = []
    for i in range(10):
        bits = 25 if i & 1 else 26
        out.append(v & ((1 << bits) - 1))
        v >>= bits
    assert v == 0
    return out


def kernel_constants() -> np.ndarray:
    """The kernel's constant block, int32: the fixed-base niels table of
    k·B for k = 0..15 as [k][y+x, y−x, 2d·t, z=2][limb], then d, 2d and
    sqrt(−1) — all derived from the port's ref25519."""
    ints = []
    for ypx, ymx, t2d in ed.base_niels_affine():
        for v in (ypx, ymx, t2d, 2):
            ints += _limbs25(v)
    for v in (ref.D, ed.D2, ref.SQRT_M1):
        ints += _limbs25(v)
    return np.asarray(ints, dtype=np.int32)


def _device_constants(device) -> torch.Tensor:
    t = _consts.get(device)
    if t is None:
        t = _consts[device] = torch.from_numpy(kernel_constants()).to(device)
    return t


def prepare(device) -> None:
    """Build and load the library, and make the constant block on
    ``device``: what a launch there needs, done before the first one."""
    load_library()
    with _lib_lock:
        _device_constants(torch.device(device))


def verify_packed(p: torch.Tensor) -> torch.Tensor:
    """Verdicts of the packed (128, N) uint8 chunk -> (N,) bool.

    CPU tensor: the plain PyTorch version.  CUDA tensor: the kernel, on
    the tensor's device and that device's current stream, or an
    exception."""
    global launches
    if p.device.type == "cpu":
        return ed._verify_packed(p)
    if p.device.type != "cuda":
        raise ValueError(f"verify_packed: unsupported device {p.device}")
    if p.dtype != torch.uint8 or p.dim() != 2 or p.shape[0] != ed.ROWS:
        raise ValueError(
            f"verify_packed wants a (128, N) uint8 tensor, got "
            f"{tuple(p.shape)} {p.dtype}"
        )
    if not p.is_contiguous():
        raise ValueError("verify_packed wants a contiguous tensor")
    n = p.shape[1]
    out = torch.empty(n, dtype=torch.uint8, device=p.device)
    if n == 0:
        return out.view(torch.bool)
    lib = load_library()
    consts = _device_constants(p.device)
    if consts.numel() != lib.ed25519_const_ints():
        raise RuntimeError("kernel constant block size mismatch")
    with launch_device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.ed25519_verify_launch(
            p.data_ptr(), out.data_ptr(), n, consts.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(
            f"ed25519 verify kernel launch failed: "
            f"{lib.ed25519_error_string(err).decode()} ({err})"
        )
    with _count_lock:
        launches += 1
    return out.view(torch.bool)
