"""Build a CUDA kernel source of stellar_tpu_torch/csrc/ as host C++, for the
CPU tests of the port.

CUDA has no interpret mode.  To hold a kernel's arithmetic against its
plain PyTorch version on a host without a card, the tests compile the same
source with the host C++ compiler: the CUDA qualifiers are defined away,
everything after the anonymous namespace (the launch entry points) is cut,
and a test appends ``extern "C"`` functions that run the kernel body.

Two preludes:

- one thread (``PRELUDE``): the test calls the body one lane per call
  (``blockIdx.x = lane`` with one-thread blocks), for kernels whose threads
  never talk to each other;
- a block emulation (``BLOCK_PRELUDE``, ``threads=True``): ``host_launch``
  runs each block's CUDA threads as OS threads, one block after the other,
  with a ``thread_local`` ``threadIdx``; ``__syncthreads`` (and
  ``__syncthreads_or``) is a ``std::barrier`` over the block, ``__syncwarp``
  one over the launch's width-wide group (launch with width 32 for warp
  code), and ``__shfl_sync`` an exchange through a double buffer behind a
  barrier of the shuffle's width-wide group (C++20, ``-pthread``), and
  ``__reduce_max_sync`` the same exchange read whole.  Every thread of a
  group must reach every shuffle, as on the card.

Both preludes define ``__byte_perm``, ``__ldg`` and ``uint4``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import pytest

_QUALIFIERS = r"""
#include <stddef.h>
#include <stdint.h>
#include <algorithm>
using std::min;
#define __global__
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct Dim3 { int x, y, z; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
// a load through the read-only data cache
template <typename T>
static inline T __ldg(const T *p) { return *p; }
// byte k of the result is byte (s >> 4k) & 7 of the 8 bytes y:x
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
    const uint64_t v = (uint64_t)y << 32 | x;
    uint32_t r = 0;
    for (int k = 0; k < 4; k++) r |= (uint32_t)(v >> (8 * ((s >> (4 * k)) & 7)) & 0xff) << (8 * k);
    return r;
}
"""

PRELUDE = _QUALIFIERS + r"""
#define __syncthreads()
static Dim3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1};
// a group of one thread
static inline unsigned __reduce_max_sync(unsigned, unsigned v) { return v; }
"""

BLOCK_PRELUDE = _QUALIFIERS + r"""
#include <atomic>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
static thread_local Dim3 threadIdx = {0, 0, 0};
static Dim3 blockIdx = {0, 0, 0}, blockDim = {1, 1, 1};
static const int kHostMaxThreads = 1024;
static std::barrier<> *host_block_barrier;
static std::barrier<> *host_group_barrier[kHostMaxThreads];
static int host_group_width = 1;
static int32_t host_shfl_buf[2][kHostMaxThreads];
static thread_local unsigned host_shfl_phase = 0;
static std::atomic<int> host_bar_or[2];
static thread_local unsigned host_bar_or_phase = 0;

static inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

// Consecutive calls alternate slots: thread 0 clears a slot after every
// thread has read it, before any thread can reach the call that reuses it.
static inline int __syncthreads_or(int pred) {
    std::atomic<int> &slot = host_bar_or[host_bar_or_phase++ & 1];
    if (pred) slot.store(1);
    host_block_barrier->arrive_and_wait();
    const int any = slot.load();
    host_block_barrier->arrive_and_wait();
    if (threadIdx.x == 0) slot.store(0);
    return any;
}

// A barrier of the calling thread's width-wide group: a warp when the
// kernel is launched with width 32.
static inline void __syncwarp(unsigned = 0xffffffffu) {
    host_group_barrier[threadIdx.x - threadIdx.x % host_group_width]->arrive_and_wait();
}

// Every thread of the group writes its value, waits for the group, reads
// its source's.  Consecutive shuffles alternate buffers: a thread can
// write shuffle k+2's value only after the whole group has passed shuffle
// k+1's barrier, so after every read of shuffle k.
template <typename T>
static inline T __shfl_sync(unsigned, T v, int src, int width) {
    const int t = threadIdx.x, base = t - t % width;
    int32_t *buf = host_shfl_buf[host_shfl_phase++ & 1];
    buf[t] = (int32_t)v;
    host_group_barrier[base]->arrive_and_wait();
    return (T)buf[base + src % width];
}

// The maximum of the group's values, through the shuffle's buffers.
static inline unsigned __reduce_max_sync(unsigned, unsigned v) {
    const int t = threadIdx.x, base = t - t % host_group_width;
    int32_t *buf = host_shfl_buf[host_shfl_phase++ & 1];
    buf[t] = (int32_t)v;
    host_group_barrier[base]->arrive_and_wait();
    unsigned m = 0;
    for (int k = 0; k < host_group_width; k++) m = std::max(m, (unsigned)buf[base + k]);
    return m;
}

// Run `body` as `blocks` blocks of `threads` CUDA threads, one block after
// the other; shuffles go across groups of `width` threads.
template <typename F>
static void host_launch(int blocks, int threads, int width, F body) {
    blockDim.x = threads;
    host_group_width = width;
    for (int b = 0; b < blocks; b++) {
        blockIdx.x = b;
        std::barrier<> block(threads);
        host_block_barrier = &block;
        std::vector<std::unique_ptr<std::barrier<>>> groups;
        for (int g = 0; g < threads; g += width) {
            groups.emplace_back(new std::barrier<>(width));
            host_group_barrier[g] = groups.back().get();
        }
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; t++)
            pool.emplace_back([t, &body] {
                threadIdx.x = t;
                body();
            });
        for (auto &th : pool) th.join();
    }
}
"""


def build_host_kernel(source: str, host_loop: str, out_dir, threads: bool = False) -> ctypes.CDLL:
    """Compile ``source`` (a .cu file) plus ``host_loop`` into a shared
    library in ``out_dir`` and load it; skips when no C++ compiler exists.
    ``threads`` selects the block emulation (``host_launch``)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    src = open(source).read().replace("#include <cuda_runtime.h>", "")
    src = src[: src.index("}  // namespace")] + "}  // namespace\n"
    cpp, so = os.path.join(out_dir, "kernel.cpp"), os.path.join(out_dir, "kernel.so")
    with open(cpp, "w") as f:
        f.write((BLOCK_PRELUDE if threads else PRELUDE) + src + host_loop)
    std = ["-std=c++20", "-pthread"] if threads else ["-std=c++17"]
    r = subprocess.run(
        [cxx, "-O2", *std, "-shared", "-fPIC", "-o", so, cpp],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(so)
