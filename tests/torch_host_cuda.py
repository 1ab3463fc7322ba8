"""Build a CUDA kernel source of stellar_tpu_torch/csrc/ as host C++, for the
CPU tests of the port.

CUDA has no interpret mode.  To hold a kernel's arithmetic against its
plain PyTorch version on a host without a card, the tests compile the same
source with the host C++ compiler: the CUDA qualifiers are defined away,
everything after the anonymous namespace (the launch entry points) is cut,
and a test appends ``extern "C"`` functions that call the kernel body one
lane per call (``blockIdx.x = lane`` with one-thread blocks).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import pytest

PRELUDE = r"""
#include <stddef.h>
#include <stdint.h>
#define __global__
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __syncthreads()
struct Dim3 { int x, y, z; };
static Dim3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1};
"""


def build_host_kernel(source: str, host_loop: str, out_dir) -> ctypes.CDLL:
    """Compile ``source`` (a .cu file) plus ``host_loop`` into a shared
    library in ``out_dir`` and load it; skips when no C++ compiler exists."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    src = open(source).read().replace("#include <cuda_runtime.h>", "")
    src = src[: src.index("}  // namespace")] + "}  // namespace\n"
    cpp, so = os.path.join(out_dir, "kernel.cpp"), os.path.join(out_dir, "kernel.so")
    with open(cpp, "w") as f:
        f.write(PRELUDE + src + host_loop)
    r = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so, cpp],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(so)
