"""Wrapper of the hand-written Hopper verify kernel (``csrc/ed25519_verify.cu``).

The kernel replaces the TPU kernel ``stellar_tpu/ops/ed25519_pallas.py::
verify_kernel_pallas``.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point and loaded with ``ctypes`` — no
PyTorch headers, so the build takes seconds.  The build runs at first use,
from the sources in the repository only, into the gitignored build
directory, under a name keyed by a hash of the source and the flags.

``verify_packed(p, signed=None, variant=None)`` on a CPU tensor runs the
plain PyTorch version (``ops/ed25519.py::_verify_packed``); on a CUDA
tensor it launches a kernel or raises.  ``signed`` picks the signed-digit
windows (``verify_kernel_pallas(signed=True)``); None reads the module
constant ``ops/ed25519.py::_SIGNED_WIN`` (``STELLAR_TPU_SIGNED_WINDOWS``)
at the call.  The signed windows have two kernels (``SIGNED_VARIANTS``):
"wide", the signed instance of the unsigned kernel's template, and
"pair", a chain warp and a comb warp over the same signatures, for narrow
launches; ``signed_variant(n)`` picks one by the launch's width, and
``variant`` forces one.  ``launches`` counts the unsigned kernel's
launches, ``signed_launches`` the wide variant's and
``signed_pair_launches`` the pair's.  Each kernel runs a lane on a group
of 4 threads (``geometry()``).
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

# kernel launches since import (or since the caller last reset it to 0):
# the unsigned kernel, the signed windows' wide variant and their pair
launches = 0
signed_launches = 0
signed_pair_launches = 0
SIGNED_VARIANTS = ("wide", "pair")
# the widest launch the pair takes (signed_variant): two pair blocks an SM
# on the H100 SXM's 132 SMs (8 signatures a block), one warp a scheduler.
# kernel_ab.py's sweep of both variants on that card: the pair faster at
# every width up to 2112 lanes, the wide variant from 2304 (PERF.md §6)
PAIR_MAX_LANES = 2 * 132 * 8
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
        for fn in (lib.ed25519_verify_launch, lib.ed25519_verify_signed_launch):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.ed25519_verify_signed_pair_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ed25519_verify_signed_pair_launch.restype = ctypes.c_int
        lib.ed25519_residency.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.ed25519_residency.restype = ctypes.c_int
        for fn in (lib.ed25519_const_ints, lib.ed25519_comb_ints, lib.ed25519_threads_per_lane,
                   lib.ed25519_block_threads):
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


def signed_variant(n: int) -> str:
    """The signed-window kernel a launch of ``n`` lanes runs: the pair up to
    ``PAIR_MAX_LANES`` lanes, where it is the faster, else the wide variant."""
    return "pair" if n <= PAIR_MAX_LANES else "wide"


def _residency(kernel: int, device) -> dict:
    lib = load_library()
    info = np.zeros(6, dtype=np.int32)
    with launch_device(torch.device("cuda") if device is None else torch.device(device)):
        err = lib.ed25519_residency(kernel, info.ctypes.data)
    if err != 0:
        raise RuntimeError(f"ed25519_residency: {lib.ed25519_error_string(err).decode()} ({err})")
    keys = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm",
            "blocks_by_shared", "blocks_by_registers")
    return dict(zip(keys, info.tolist()))


def residency(signed: bool, device=None) -> dict:
    """Residency on ``device`` (default: the current card), from the CUDA
    runtime: registers a thread, static shared memory and local memory,
    resident blocks an SM, and the blocks an SM that shared memory alone
    and registers alone allow — of the unsigned kernel, or for ``signed``
    of each signed variant ({"wide": ..., "pair": ...})."""
    if not signed:
        return _residency(0, device)
    return {v: _residency(1 + k, device) for k, v in enumerate(SIGNED_VARIANTS)}


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


def _niels_affine(pt) -> tuple:
    """(y+x, y−x, 2d·x·y) mod p of an extended point, made affine."""
    x, y, z, _ = pt
    zinv = ref.fe_inv(z)
    xa, ya = x * zinv % ref.P, y * zinv % ref.P
    return (ya + xa) % ref.P, (ya - xa) % ref.P, xa * ya % ref.P * ed.D2 % ref.P


def comb_table() -> np.ndarray:
    """The pair's signed comb, int32 (64, 8, 3, 10): entry [i][k−1] is
    k·16^i·B for i = 0..63 and k = 1..8 in affine niels form (y+x, y−x,
    2d·x·y), each in the kernel's 10 limbs (61,440 bytes) — from the port's
    ref25519."""
    out = np.zeros((64, 8, 3, 10), dtype=np.int32)
    base = ref.base_point()
    for i in range(64):
        pt = ref.IDENT
        for k in range(8):
            pt = ref.point_add(pt, base)
            out[i, k] = [_limbs25(v) for v in _niels_affine(pt)]
        for _ in range(4):
            base = ref.point_double(base)
    return out


def _device_constants(device) -> tuple:
    """(constant block, comb) on ``device``, made at its first use there."""
    t = _consts.get(device)
    if t is None:
        t = _consts[device] = (torch.from_numpy(kernel_constants()).to(device),
                               torch.from_numpy(comb_table()).to(device))
    return t


def prepare(device) -> None:
    """Build and load the library, and make the constant block and the comb
    on ``device``: what a launch there needs, done before the first one."""
    load_library()
    with _lib_lock:
        _device_constants(torch.device(device))


def verify_packed(p: torch.Tensor, signed=None, variant=None) -> torch.Tensor:
    """Verdicts of the packed (128, N) uint8 chunk -> (N,) bool.

    CPU tensor: the plain PyTorch version.  CUDA tensor: the kernel that
    ``signed`` (None: ``ed._SIGNED_WIN``) and, for the signed windows,
    ``variant`` (None: ``signed_variant(N)``) name, on the tensor's device
    and that device's current stream, or an exception."""
    global launches, signed_launches, signed_pair_launches
    if signed is None:
        signed = ed._SIGNED_WIN
    if variant is not None and (not signed or variant not in SIGNED_VARIANTS):
        raise ValueError(f"verify_packed: no variant {variant!r} of the "
                         f"{'signed' if signed else 'unsigned'} windows")
    if p.device.type == "cpu":
        return ed._verify_packed(p, signed=signed)
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
    consts, comb = _device_constants(p.device)
    if consts.numel() != lib.ed25519_const_ints() or comb.numel() != lib.ed25519_comb_ints():
        raise RuntimeError("kernel constant block or comb size mismatch")
    kernel = (variant or signed_variant(n)) if signed else "unsigned"
    with launch_device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        if kernel == "pair":
            err = lib.ed25519_verify_signed_pair_launch(
                p.data_ptr(), out.data_ptr(), n, consts.data_ptr(), comb.data_ptr(), stream)
        else:
            launch = lib.ed25519_verify_signed_launch if signed else lib.ed25519_verify_launch
            err = launch(p.data_ptr(), out.data_ptr(), n, consts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"ed25519 verify kernel launch failed ({kernel}): "
            f"{lib.ed25519_error_string(err).decode()} ({err})"
        )
    with _count_lock:
        if kernel == "pair":
            signed_pair_launches += 1
        elif signed:
            signed_launches += 1
        else:
            launches += 1
    return out.view(torch.bool)
