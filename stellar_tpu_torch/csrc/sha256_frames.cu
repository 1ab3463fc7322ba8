// sha256_frames.cu — batched multi-block SHA-256, one lane per message, on
// Hopper: the bucket-hash plane's per-frame digests.
//
// Replaces the TPU kernel stellar_tpu/ops/sha256.py::sha256_pallas (body
// _sha256_kernel → _digest_rows; XLA twin sha256_rows_from_packed).  The
// plain PyTorch version beside it is stellar_tpu_torch/ops/sha256.py::
// sha256_rows_from_packed; the wrapper is stellar_tpu_torch/ops/
// sha256_cuda.py.
//
// Input: the padded (max_blocks·64, N) uint8 column layout of
// ops/sha256.py::pack_frames (lane j's FIPS 180-4-padded message down
// column j) and the (N,) int32 block counts.  Output: (32, N) uint8 digest
// rows, each word big-endian (the bytes hashlib gives).  Lane j chains its
// first nblocks[j] blocks, clamped to [1, max_blocks] — the TPU kernel's
// semantics: block 0 always, block b ≥ 1 while b < nblocks[j].
//
// Design (simple and correct first):
// - one thread per lane; thread j reads byte row r at p[r·N + j], so a
//   warp's loads are coalesced; the ragged tail is masked;
// - each thread loops over ITS OWN lane's block count, not max_blocks: the
//   TPU kernel computed every block for every lane and masked the state,
//   because its lanes march in lock-step; here a lane that is done stops
//   (its warp waits for the warp's longest lane);
// - the 64 rounds and the rolling 16-word schedule are fully unrolled, so
//   both stay in registers and the round constants are constant-bank
//   operands;
// - no padding of N: the TPU version padded the batch to its 512-lane tile.
//
// Bound: integer operations, counted from this source in 32-bit
// instructions (a rotate is one funnel shift, a 3-input xor/choice/
// majority one LOP3, a 3-term add one IADD3):
//   - per block: 64 rounds × 14 (Σ1 4, Ch 1, T1 2, Σ0 4, Maj 1, e 1, a 1)
//     = 896; 48 schedule words × 10 (σ0 4, σ1 4, sum 2) = 480;
//     feed-forward 8; 64 loaded bytes merged into words 64 — 1448;
//   - per lane: 32 digest bytes extracted.
// At ≈ 16.7e12 such operations/s (132 SMs × 64 INT32 lanes × 1.98 GHz)
// 10^6 two-block frames take ≈ 0.17 ms; the bytes a lane must move are
// its own blocks (64 each), 4 of count and 32 of digest, ≈ 0.05 ms at
// 3.35 TB/s: the kernel is bound by operations.  chip_smoke.py computes
// the bound from each run's block counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t kK256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

__constant__ uint32_t kIV256[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

// one compression of the 16-word block w into the chaining value st
__device__ __forceinline__ void sha256_block(uint32_t st[8], uint32_t w[16]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; t++) {
        if (t >= 16) {
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = h + S1 + ch + kK256[t] + w[t & 15];
        const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
        const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + mj;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void __launch_bounds__(kThreads)
sha256_frames_kernel(const uint8_t *__restrict__ p, const int32_t *__restrict__ nblocks,
                     uint8_t *__restrict__ out, int n, int max_blocks) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    int nb = nblocks[i];
    nb = nb < 1 ? 1 : (nb > max_blocks ? max_blocks : nb);
    uint32_t st[8];
#pragma unroll
    for (int k = 0; k < 8; k++) st[k] = kIV256[k];
#pragma unroll 1
    for (int blk = 0; blk < nb; blk++) {
        const uint8_t *col = p + (size_t)blk * 64 * N + i;
        uint32_t w[16];
#pragma unroll
        for (int t = 0; t < 16; t++)
            w[t] = ((uint32_t)col[(4 * t) * N] << 24) | ((uint32_t)col[(4 * t + 1) * N] << 16) |
                   ((uint32_t)col[(4 * t + 2) * N] << 8) | (uint32_t)col[(4 * t + 3) * N];
        sha256_block(st, w);
    }
#pragma unroll
    for (int k = 0; k < 32; k++) out[k * N + i] = (uint8_t)(st[k >> 2] >> (24 - 8 * (k & 3)));
}

}  // namespace

// Launch over n lanes of the padded (max_blocks·64, n) columns and their
// (n,) block counts on `stream`, writing (32, n) digest rows to `out`.
// Returns cudaGetLastError() (0 on success).  Allocates nothing, does not
// sync.
extern "C" int sha256_frames_launch(const void *packed, const void *nblocks, void *out,
                                    int n, int max_blocks, void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    sha256_frames_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (const int32_t *)nblocks, (uint8_t *)out, n, max_blocks);
    return (int)cudaGetLastError();
}

extern "C" const char *sha256_frames_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
