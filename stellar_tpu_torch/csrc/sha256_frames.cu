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
// Bound: integer operations, counted from the lane kernel in 32-bit
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
//
// Two kernels of the same function; pick_variant chooses by the launch's
// width and block count.
//
// The lane kernel (sha256_frames_kernel), for wide launches: one thread a
// lane, reading byte row r of its lane at p[r·N + j] (a warp's loads
// coalesced), looping over its own lane's block count (the TPU kernel
// computed every block for every lane and masked the state; here a warp
// runs its longest lane), the 64 rounds and the rolling 16-word schedule
// unrolled in registers.  With many warps on each scheduler it reaches
// ~88 % of the bound (10^6-record bucket, 859,934 two-block lanes).
//
// What sets the time of a narrow launch instead (a 4 MB bucket flush makes
// launches of 5,042 and 360 lanes, 40 and 3 blocks of 128 threads): one
// lane's 64 rounds a block are a serial chain, and each SM that has work
// holds one warp a scheduler, so nothing hides a stall.  A warp's INT32
// instruction takes 2 cycles of its scheduler's 16 INT32 lanes; the lane
// kernel runs ~24 a round (14 round, 10 schedule) and waits on its
// block's 64 byte loads, sent only when the block starts.  Block 0's
// clock64 stamps on an H100 SXM (kernel_ab.py, -DSHA256_FRAMES_STAMPS):
// ~1,100-1,800 cycles of load wait, then ~2,800 of compression a block
// (~44 a round) — ~2.8 µs a block, 2 µs fixed, whatever the width up to
// ~16,000 lanes.
//
// The pair kernel (sha256_frames_pair_kernel), for narrow launches: a block
// is 64 threads, two warps over the same 32 lanes, one on each of two
// schedulers.
// - The schedule warp loads a block's bytes (row addresses formed from one
//   warp-wide row pointer, none waiting on another), merges them into
//   big-endian words and computes W[16..63]; it writes W[t] + K[t] to the
//   shared tile wk[t][lane] (a warp's accesses on distinct banks), a
//   chunk of 16 words one stage before the rounds read it: wk is a ring
//   of four 16-word chunks (8 KB).
// - The round warp runs the rounds from wk, 8 a loop pass, with no
//   schedule and no K in its stream: ~15 instructions a round, d + h +
//   W + K formed beside Σ1 (rounds16).
// - A block of the message is four stages, a 64-thread barrier after each
//   (__syncthreads).  The next block's 64 byte loads are spread over
//   stages 0-2 and merged at stage 3, so no load is waited on while the
//   rounds run.
// - A pair runs the largest clamped count of its 32 lanes; a lane past its
//   own blocks keeps its digest, and reads (and drops) the rows of the
//   pair's later blocks, which the layout holds for every lane.
// Stamps on an H100 SXM: 606-611 cycles for 16 rounds (~38 a round), the
// round warp the longer of the two at every stage: ~2,640 cycles a block
// against the lane kernel's ~3,900.  At width it runs more instructions
// a lane than the lane kernel (loads, shared stores and loads, barriers)
// on two warps, and 128 registers a thread hold 8 pairs an SM.
//
// Crossover (kernel_ab.py --kernel sha256_frames: both kernels forced at
// each width, 1 to 16 blocks a lane, H100 80GB HBM3 at 700 W).  Pair over
// lane: 0.61-0.75 (1-2 blocks), 0.53 (4), 0.50-0.52 (8), 0.44-0.46 (16)
// up to 8,192 lanes.  Wider, both kernels' times step with the busiest
// SM's load, the lane kernel's every 16,896 lanes (a 128-lane block on each
// of 132 SMs), the pair's every 8,448, so the winner alternates near the
// crossover: with 4 blocks the pair wins at 38,573 (0.90) and 57,344
// (0.96) lanes, where the lane kernel's last step is at most half full,
// and loses at 45,056 (1.03) and 65,536 (1.08).  pick_variant counts a
// launch in the lane kernel's steps and runs the pair up to kPairSteps
// of them: 1 step (16,896 lanes) at 1-2 blocks, 3 when the last is at most
// half full; 2 and 4 at 4-8 blocks; 7 from 16 blocks.  It picks the faster
// kernel at every width measured (the closest: 0.991 with 1 block at 40,960
// lanes, 0.998 with 16 at 114,688); past the widest measured (131,072
// lanes) the lane kernel runs.  The whole bucket's two-block class
// (859,934 lanes) runs the lane kernel (pair/lane 1.19).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // the lane kernel: one thread a lane
constexpr int kPairLanes = 32;   // the pair kernel: two warps over 32 lanes
constexpr int kPairThreads = 64;
// the kernels, as sha256_frames_variant names them
constexpr int kLane = 0;
constexpr int kPair = 1;
// The rule (pick_variant, header note): the lane kernel's time steps with
// its 128-lane blocks on the busiest of the H100's 132 SMs, so a launch is
// measured in those steps; the pair runs up to kPairSteps[c][h] steps, c
// the class of max_blocks (1, 2, 4, 8, 16 and more) and h = 1 when the
// last step is at most half full
constexpr int kLaneStep = 128 * 132;
constexpr int kPairSteps[5][2] = {{1, 3}, {1, 3}, {2, 4}, {2, 4}, {7, 7}};

// Cycle stamps of block 0's first two warps (the pair: [0] the schedule
// warp, [1] the round warp) at the phase boundaries, and the global timer
// (ns) at thread 0's first and last stamp, read by kernel_ab.py from a
// build with -DSHA256_FRAMES_STAMPS; nothing otherwise.
constexpr int kStamps = 48;
#ifdef SHA256_FRAMES_STAMPS
__device__ long long g_stamps[2][kStamps];
__device__ unsigned long long g_ns[2];
__device__ __forceinline__ void stamp(int k) {
    if (blockIdx.x == 0 && threadIdx.x < 64 && (threadIdx.x & 31) == 0 && k < kStamps)
        g_stamps[threadIdx.x >> 5][k] = clock64();
}
__device__ __forceinline__ void stamp_ns(int k) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        g_ns[k] = t;
    }
}
#else
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void stamp_ns(int) {}
#endif

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
    stamp_ns(0);
    stamp(0);
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
        stamp(1 + 2 * blk);  // the block's words merged: its loads arrived
        sha256_block(st, w);
        stamp(2 + 2 * blk);
    }
#pragma unroll
    for (int k = 0; k < 32; k++) out[k * N + i] = (uint8_t)(st[k >> 2] >> (24 - 8 * (k & 3)));
    stamp(kStamps - 1);
    stamp_ns(1);
}

__device__ __forceinline__ uint32_t sigma0(uint32_t x) {
    return rotr32(x, 7) ^ rotr32(x, 18) ^ (x >> 3);
}

__device__ __forceinline__ uint32_t sigma1(uint32_t x) {
    return rotr32(x, 17) ^ rotr32(x, 19) ^ (x >> 10);
}

// The schedule warp's loads of rows R0..R1−1 of one block: byte `lane_off`
// of each row from `rows` down, n apart, sent together and used only at
// the block's last stage.
template <int R0, int R1>
__device__ __forceinline__ void load_rows(const uint8_t *__restrict__ rows, unsigned n,
                                          unsigned lane_off, uint32_t (&bytes)[64]) {
#pragma unroll
    for (int r = R0; r < R1; r++) bytes[r] = rows[(size_t)n * r + lane_off];
}

// Words 0..15 of a block from its loaded bytes, into w and, with K added,
// into wk rows 0..15.
__device__ __forceinline__ void merge_block(const uint32_t (&bytes)[64], uint32_t (&w)[16],
                                            uint32_t (*wk)[kPairLanes], int lane) {
#pragma unroll
    for (int t = 0; t < 16; t++) {
        w[t] = bytes[4 * t] << 24 | bytes[4 * t + 1] << 16 | bytes[4 * t + 2] << 8 |
               bytes[4 * t + 3];
        wk[t][lane] = w[t] + kK256[t];
    }
}

// Words 16c..16c+15 of the block (c = 1, 2, 3): w holds W[16(c−1)..] and
// rolls forward; W + K into wk rows 16c..
template <int C>
__device__ __forceinline__ void schedule_chunk(uint32_t (&w)[16], uint32_t (*wk)[kPairLanes],
                                               int lane) {
#pragma unroll
    for (int j = 0; j < 16; j++) {
        // w[j] holds W[t − 16]; W[t] = σ1(W[t−2]) + W[t−7] + σ0(W[t−15]) + W[t−16]
        w[j] += sigma0(w[(j + 1) & 15]) + w[(j + 9) & 15] + sigma1(w[(j + 14) & 15]);
        wk[16 * C + j][lane] = w[j] + kK256[16 * C + j];
    }
}

// Rounds 16c..16c+15 from wk, 8 a pass: the state comes back to its names,
// and a short loop body is fetched once.  d + h + W + K is formed beside
// Σ1, and a' = e' + (Σ0 + Maj − d) (e' = d + T1, a' = T1 + Σ0 + Maj), so
// neither new value waits on T1 alone.
__device__ __forceinline__ void rounds16(uint32_t (&v)[8], const uint32_t (*wk)[kPairLanes], int c,
                                         int lane) {
    uint32_t a = v[0], b = v[1], cc = v[2], d = v[3], e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll 1
    for (int t = 16 * c; t < 16 * c + 16; t += 8) {
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const uint32_t dhk = d + h + wk[t + j][lane];
            const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            const uint32_t ch = (e & f) ^ (~e & g);
            const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            const uint32_t mj = (a & b) ^ (a & cc) ^ (b & cc);
            const uint32_t y = S0 + mj - d;
            h = g; g = f; f = e; e = dhk + S1 + ch;
            d = cc; cc = b; b = a; a = e + y;
        }
    }
    v[0] = a; v[1] = b; v[2] = cc; v[3] = d; v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

__global__ void __launch_bounds__(kPairThreads)
sha256_frames_pair_kernel(const uint8_t *__restrict__ p, const int32_t *__restrict__ nblocks,
                          uint8_t *__restrict__ out, int n, int max_blocks) {
    // W[t] + K[t] of the block in flight, lane j's word t at wk[t][j]: a
    // ring of four 16-word chunks, each written one stage before it is read
    __shared__ uint32_t wk[64][kPairLanes];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i = blockIdx.x * kPairLanes + lane;
    const bool live = i < n;
    int nb = live ? nblocks[i] : 0;
    nb = !live ? 0 : nb < 1 ? 1 : (nb > max_blocks ? max_blocks : nb);
    // both warps take the same maximum over the same 32 lanes, so they
    // pass the same barriers
    const int nbmax = (int)__reduce_max_sync(0xffffffffu, (unsigned)nb);
    // the pair's 32 columns from row 0: lane `lane_off` of them (a dead
    // lane reads lane n−1's column); 64·n bytes a block
    const uint8_t *rows = p + (size_t)blockIdx.x * kPairLanes;
    const unsigned un = (unsigned)n, lane_off = live ? lane : n - 1 - blockIdx.x * kPairLanes;
    const size_t block_bytes = (size_t)64 * n;
    uint32_t w[16], bytes[64];
    stamp_ns(0);
    stamp(0);
    if (warp == 0) {
        load_rows<0, 64>(rows, un, lane_off, bytes);
        merge_block(bytes, w, wk, lane);
    }
    stamp(1);
    __syncthreads();
    stamp(2);
    uint32_t st[8], v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) st[k] = v[k] = kIV256[k];
    // block blk in four stages, a barrier after each: in stage c the round
    // warp runs rounds 16c.. from wk rows 16c.., while the schedule warp
    // writes the next chunk — words 16(c+1).. of the block, or at c = 3
    // words 0..15 of block blk+1, from bytes whose loads it sent over
    // stages 0-2
#pragma unroll 1
    for (int blk = 0; blk < nbmax; blk++) {
        const int s = 4 * blk;
        if (warp == 0) {
            // every lane reads block blk+1: it exists in the layout for
            // all (blk + 1 < nbmax ≤ max_blocks), and a lane past its own
            // blocks drops it
            rows += block_bytes;
            if (blk + 1 < nbmax) load_rows<0, 22>(rows, un, lane_off, bytes);
            schedule_chunk<1>(w, wk, lane);
        } else {
            rounds16(v, wk, 0, lane);
        }
        stamp(3 + 2 * s);  // the stage's work done
        __syncthreads();
        stamp(4 + 2 * s);
        if (warp == 0) {
            if (blk + 1 < nbmax) load_rows<22, 44>(rows, un, lane_off, bytes);
            schedule_chunk<2>(w, wk, lane);
        } else {
            rounds16(v, wk, 1, lane);
        }
        stamp(5 + 2 * s);
        __syncthreads();
        stamp(6 + 2 * s);
        if (warp == 0) {
            if (blk + 1 < nbmax) load_rows<44, 64>(rows, un, lane_off, bytes);
            schedule_chunk<3>(w, wk, lane);
        } else {
            rounds16(v, wk, 2, lane);
        }
        stamp(7 + 2 * s);
        __syncthreads();
        stamp(8 + 2 * s);
        if (warp == 0) {
            merge_block(bytes, w, wk, lane);
        } else {
            rounds16(v, wk, 3, lane);
            if (blk < nb) {  // a lane past its own blocks keeps its digest
#pragma unroll
                for (int k = 0; k < 8; k++) st[k] += v[k];
            }
#pragma unroll
            for (int k = 0; k < 8; k++) v[k] = st[k];
        }
        stamp(9 + 2 * s);
        __syncthreads();
        stamp(10 + 2 * s);
    }
    if (warp == 1 && live) {
        const size_t N = (size_t)n;
#pragma unroll
        for (int k = 0; k < 32; k++) out[k * N + i] = (uint8_t)(st[k >> 2] >> (24 - 8 * (k & 3)));
    }
    stamp(kStamps - 1);
    stamp_ns(1);
}

// The kernel a launch of n lanes of max_blocks blocks runs: the pair up to
// the measured crossover (header note), one thread a lane past it.
inline int pick_variant(int n, int max_blocks) {
    int c = 0;
    while (c < 4 && (1 << c) < max_blocks) c++;
    const int steps = (n + kLaneStep - 1) / kLaneStep;
    const bool half = n - (steps - 1) * kLaneStep <= kLaneStep / 2;
    return steps <= kPairSteps[c][half] ? kPair : kLane;
}

}  // namespace

// Launch kernel `variant` (0 the lane kernel, 1 the pair) over n lanes of
// the padded (max_blocks·64, n) columns and their (n,) block counts on
// `stream`, writing (32, n) digest rows to `out`.  Returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for an unknown
// variant).  Allocates nothing, does not sync.
extern "C" int sha256_frames_launch_as(const void *packed, const void *nblocks, void *out, int n,
                                       int max_blocks, int variant, void *stream) {
    if (n <= 0) return 0;
    const uint8_t *p = (const uint8_t *)packed;
    const int32_t *nb = (const int32_t *)nblocks;
    if (variant == kLane) {
        sha256_frames_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
            p, nb, (uint8_t *)out, n, max_blocks);
    } else if (variant == kPair) {
        sha256_frames_pair_kernel<<<(n + kPairLanes - 1) / kPairLanes, kPairThreads, 0,
                                    (cudaStream_t)stream>>>(p, nb, (uint8_t *)out, n, max_blocks);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The kernel that sha256_frames_launch runs for n lanes of max_blocks
// blocks: 0 the lane kernel, 1 the pair.
extern "C" int sha256_frames_variant(int n, int max_blocks) { return pick_variant(n, max_blocks); }

// Launch the kernel of the rule (sha256_frames_variant) over n lanes; as
// sha256_frames_launch_as.
extern "C" int sha256_frames_launch(const void *packed, const void *nblocks, void *out,
                                    int n, int max_blocks, void *stream) {
    return sha256_frames_launch_as(packed, nblocks, out, n, max_blocks,
                                   pick_variant(n, max_blocks), stream);
}

#ifdef SHA256_FRAMES_STAMPS
// Copy block 0's stamps of the last launch to `host` ([2][kStamps] cycles,
// then the two global-timer ns) and clear them; synchronises the device.
extern "C" int sha256_frames_stamps(long long *host) {
    static const long long zero[2][kStamps] = {};
    cudaDeviceSynchronize();
    cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
    cudaMemcpyFromSymbol(host + 2 * kStamps, g_ns, sizeof(g_ns));
    cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
    return (int)cudaGetLastError();
}
#endif

extern "C" const char *sha256_frames_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
