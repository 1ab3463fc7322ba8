// sha512_h.cu — h = SHA-512(R‖A‖M) mod L per lane on Hopper: the device-hash
// stage of the verify plane.
//
// Replaces the TPU kernel stellar_tpu/ops/sha512.py::sha512_pallas (body
// _sha_kernel → _h_rows; XLA twin h_rows_from_packed).  The plain PyTorch
// version beside it is stellar_tpu_torch/ops/sha512.py::h_rows_from_packed;
// the wrapper is stellar_tpu_torch/ops/sha512_cuda.py.  Beside it, ahead of
// it on the verify plane, dh_rows_to_cols_kernel (below) turns the host
// stage's item-major chunk into this input layout.
//
// Input: the packed (160, N) uint8 device-hash staging chunk, one lane per
// column (ops/sha512.py): rows 0:32 A, 32:64 R, 64:96 s, 96:144 M (raw
// message, mlen ≤ 47) or a host h in 96:128, row 144 mlen, row 145 flag.
// Output: (32, N) uint8 h rows, little-endian, written at `out` with row
// stride N.  A flag ≠ 0 lane hashes the single padded 128-byte block of
// R‖A‖M (80 rounds) and reduces the 512-bit digest mod L; a flag = 0 lane
// writes its uploaded h (rows 96:128) through unchanged.
//
// Bound: integer operations, counted per flag ≠ 0 lane in 32-bit
// instructions (a 64-bit rotate or shift is two funnel shifts, a 3-input
// xor/choice/majority one LOP3 per half, a 3-term 64-bit add two IADD3s, a
// 32×32→64 multiply-add with its carry add 4):
//   - 80 rounds × 28 (Σ1 8, Ch 2, T1 4, Σ0 8, Maj 2, e 2, a 2) = 2240;
//   - 64 schedule words × 20 (σ0 8, σ1 8, sum 4) = 1280;
//   - feed-forward 16; block assembly 210 (112 loaded bytes merged, 2 per
//     message byte for the padding select, the length word);
//   - mod L 510 (72 limb products × 4, B extraction 36, A + K − T 114,
//     compare and subtract 24, digest byte swaps 16, h bytes 32);
// 4256 a lane, ≈ 0.25 ns a lane on an H100 SXM (132 SMs × 64 INT32 lanes
// × 1.98 GHz).  Bytes: 114 read and 32 written a hashed lane, 33 and 32 a
// passthrough lane.  chip_smoke.py computes the bound from each run's
// lanes: ≈ 0.78 µs at the verify plane's 4096-lane chunk (3075 hashed).
//
// What sets the time instead: one lane's 80 rounds are strictly serial, and
// a 4096-lane chunk is 128 warps of lanes — at most one warp per scheduler
// on 132 SMs, so no other warp hides a stall.  A warp's INT32 instruction
// takes 2 cycles of its scheduler's 16 INT32 lanes, so one warp issuing
// integer work runs at most one instruction per 2 cycles.  The rounds
// compile to ~26 integer-pipe instructions a round (12 funnel shifts, 8
// LOP3, 6 IADD3; some carries go to the multiply pipe as IMAD.X):
// 80 × 26 × 2 ≈ 4160 cycles ≈ 2.1 µs at 1.98 GHz, the floor of any design
// that keeps a lane's rounds on one warp — alone above the whole bound.
// One thread doing the whole lane (the first port) also issued the
// schedule in that stream, ~44 instructions a round.
//
// Design: a warp-specialised pair.  A block is 64 threads, two warps over
// the same 32 lanes (a 4096-lane chunk is 128 blocks on 128 SMs):
// - warp 0, the schedule warp, loads the block's lanes (rows 0:64 and
//   96:144 into a transposed shared tile, see below), assembles W[0..15]
//   with the padding and the length word, then computes W[16..79] and
//   writes W[t] + K[t] to shared memory (wk[80][32], 20 KB; lane j's word
//   t at wk[t][j], so a warp's 64-bit accesses fall on distinct banks);
//   after its last words it writes the flag-0 lanes' h through;
// - warp 1, the round warp, runs the 80 rounds reading wk[t][lane], ~29
//   instructions a round, 8 rounds a loop pass (a short body: code that
//   runs once is fetched, and fetching costs as much as issuing), then
//   the feed-forward, mod L and the 32 h bytes;
// - stages are split by __syncthreads every 16 words: in stage s the
//   schedule warp computes W[16(s+1) .. 16(s+2)−1] while the round warp
//   runs rounds 16s .. 16s+15 on words written a stage earlier.  The two
//   warps sit on two schedulers of the SM and issue at once; a stage
//   costs the slower of the two, and the two are close (~350 and ~470
//   instructions), so the rounds wait little;
// - a block whose live lanes all have flag 0 does no rounds
//   (__syncthreads_or after the loads).
// kernel_ab.py --kernel sha512_h prints block 0's cycle stamps at these
// phase boundaries (the source built with -DSHA512_H_STAMPS).
//
// Loads.  Lane j's byte row r is p[r·N + j].  Where N % 4 == 0 (and the
// chunk is 4-byte aligned: every chunk width the verify plane makes, 4096,
// 904 and 300, qualifies), thread t of the schedule warp loads 32-bit words
// — 4 rows × 4 lanes a load, 28 loads a thread for the block's 112 rows,
// all issued before the first is used — transposes each 4×4 byte square
// with 8 byte permutes, and stores each lane's 4 rows as one word of
// tile[lane]; after __syncwarp each lane reads its own 28 words.
// Otherwise each lane loads its own 112 bytes.  TMA and cp.async.bulk do
// not fit this layout: they need 16-byte multiples of row pitch and
// address, which N = 904 or 300 do not give, and padding N would change
// the staging layout the verify kernel reads too.
//
// In place: the verify plane passes out = packed + 96·N, so h lands in
// rows 96:128 of the uploaded tensor and its first 128 rows are the
// (128, N) layout csrc/ed25519_verify.cu reads — no copy, no concat.  Only
// the schedule warp reads rows 0:64 and 96:145 (the round warp reads
// row 145, the flag, which no one writes), all before the block's first barrier; the
// round warp writes a flag ≠ 0 lane's h only after that barrier, and the
// schedule warp writes only flag-0 lanes (the bytes it read).  A block
// touches only its own 32 columns.  Hence no __restrict__ on p/out.
//
// SHA-512 words are uint64_t (the TPU's hi/lo int32 pairs existed only
// because the TPU has no 64-bit lanes).  mod L is the JAX kernel's
// branch-free fold at 2^252 against c = L − 2^252, on 32-bit limbs: four
// folds, each adding a precomputed multiple K of L that covers the B·c it
// subtracts, then a subtract of L kept if it does not borrow (bounds at
// mod_l below); B·c is summed in 64-bit pairs of products by multiply-adds
// (fold252), so one carry chain a fold remains.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowM = 96;
constexpr int kRowMlen = 144;
constexpr int kRowFlag = 145;
constexpr int kMaxMsg = 47;
constexpr int kLanes = 32;     // lanes a block
constexpr int kThreads = 64;   // two warps over the same lanes
constexpr int kTileWords = 28; // a lane's 112 loaded rows, 4 to a word
constexpr int kTilePitch = 29; // odd: a warp's accesses hit 32 banks

// Cycle stamps of block 0's two warps at the phase boundaries, read by
// kernel_ab.py from a build with -DSHA512_H_STAMPS; nothing otherwise.
#ifdef SHA512_H_STAMPS
__device__ long long g_stamps[2][16];
#define STAMP(k) \
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) g_stamps[threadIdx.x >> 5][k] = clock64();
#else
#define STAMP(k)
#endif

__constant__ uint64_t kK512[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

__constant__ uint64_t kIV512[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull,
};

// c = L − 2^252 (125 bits), L, and the fold compensators
// K1 = (⌊2^385 / L⌋ + 1)·L and K2 = (⌊2^260 / L⌋ + 1)·L, as little-endian
// 32-bit limbs
__constant__ uint32_t kC[4] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu};
__constant__ uint32_t kL[8] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                               0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
__constant__ uint32_t kK1[13] = {0x1ca10f0bu, 0xe50e20c7u, 0xe657e1abu, 0xa849fb57u,
                                 0x9eba7d9cu, 0x024c634bu, 0x5ef39acbu, 0x0bdf3bd4u,
                                 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
                                 0x00000002u};
__constant__ uint32_t kK2[9] = {0xf5d3ed00u, 0x12631a5cu, 0xf79cd658u, 0xdef9dea2u,
                                0x00000014u, 0x00000000u, 0x00000000u, 0x00000000u,
                                0x00000010u};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t v) { return __byte_perm(v, 0, 0x0123); }

// One fold at 2^252: x = A + B·2^252 with A < 2^252 (x in NX limbs),
// y = A + K − B·c in NY limbs, K ≥ B·c a multiple of L, so y ≡ x (mod L)
// and y ≥ 0; the bounds at mod_l keep y below 2^(32·NY).
template <int NX, int NY>
__device__ __forceinline__ void fold252(const uint32_t (&x)[NX], const uint32_t *k,
                                        uint32_t (&y)[NY]) {
    constexpr int NB = NX - 7;
    uint32_t b[NB];
#pragma unroll
    for (int j = 0; j < NB; j++)
        b[j] = (x[7 + j] >> 28) | (j + 8 < NX ? x[8 + j] << 4 : 0u);
    // T = B·c by columns.  c0 + c1 and c2 + c3 are each below 2^32 (c's
    // limbs at kC), so the pair sums P[j] = b[j]·c0 + b[j−1]·c1 and
    // Q[j] = b[j−2]·c2 + b[j−3]·c3 fit in 64 bits: two multiply-adds each,
    // on the multiply pipe, no carries.  Column j of T is then the low
    // halves of P[j], Q[j] plus the high halves of P[j−1], Q[j−1]; every
    // term is ≥ 0, so a column at or past NY is 0 whenever T < 2^(32·NY).
    uint64_t P[NB + 3], Q[NB + 3];
#pragma unroll
    for (int j = 0; j < NB + 3; j++) {
        P[j] = Q[j] = 0;
        if (j < NB) P[j] = (uint64_t)b[j] * kC[0];
        if (j >= 1 && j - 1 < NB) P[j] += (uint64_t)b[j - 1] * kC[1];
        if (j >= 2 && j - 2 < NB) Q[j] = (uint64_t)b[j - 2] * kC[2];
        if (j >= 3 && j - 3 < NB) Q[j] += (uint64_t)b[j - 3] * kC[3];
    }
    int64_t acc = 0;
#pragma unroll
    for (int j = 0; j < NY; j++) {
        int64_t v = (int64_t)k[j];
        if (j < 7) v += x[j];
        if (j == 7) v += x[7] & 0x0fffffffu;
        if (j < NB + 3) v -= (int64_t)(uint32_t)P[j] + (uint32_t)Q[j];
        if (j >= 1 && j - 1 < NB + 3) v -= (int64_t)(P[j - 1] >> 32) + (int64_t)(Q[j - 1] >> 32);
        v += acc;  // the one dependent add of the carry chain
        y[j] = (uint32_t)v;
        acc = (v - (int64_t)(uint32_t)v) / 4294967296ll;  // exact floor
    }
}

// The 512-bit value x (16 little-endian limbs) mod L, as 8 limbs:
//   fold 1: B < 2^260, B·c < 2^385 ≤ K1 < 2^386  → y1 < 2^387 (13 limbs)
//   fold 2: B < 2^135, B·c < 2^260 ≤ K2 < 2^261  → y2 < 2^262 (9 limbs)
//   fold 3: B < 2^10,  B·c < 2^135 < L = K       → y3 < 2^254 (8 limbs)
//   fold 4: B < 4,     B·c < 2^127 < L = K       → y4 < 2^252 + L < 2L
//   then y4 − L if that does not borrow.
__device__ __forceinline__ void mod_l(const uint32_t (&x)[16], uint32_t (&r)[8]) {
    uint32_t y1[13], y2[9], y3[8];
    fold252<16, 13>(x, kK1, y1);
    fold252<13, 9>(y1, kK2, y2);
    fold252<9, 8>(y2, kL, y3);
    fold252<8, 8>(y3, kL, r);
    uint32_t d[8];  // r − L
    int64_t acc = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        const int64_t v = acc + (int64_t)r[j] - (int64_t)kL[j];
        d[j] = (uint32_t)v;
        acc = (v - (int64_t)(uint32_t)v) / 4294967296ll;
    }
#pragma unroll
    for (int j = 0; j < 8; j++) r[j] = acc == 0 ? d[j] : r[j];  // no borrow: r ≥ L
}

// Packed row of tile row r: rows 0:64 (A, R), then 96:144 (M)
__device__ __forceinline__ int packed_row(int r) { return r < 64 ? r : r - 64 + kRowM; }

// The schedule warp's loads: tile[j][k] holds lane j's tile rows 4k..4k+3
// as the bytes of one word (row 4k in the low byte).
__device__ __forceinline__ void load_tile(const uint8_t *p, size_t N, int n, int base,
                                          bool words, uint32_t (*tile)[kTilePitch]) {
    const int t = threadIdx.x & 31;
    if (words) {
        // 224 squares of 4 rows × 4 lanes: square g covers rows 4(g/8)..+3
        // and lanes base + 4(g%8)..+3
#pragma unroll
        for (int q = 0; q < kTileWords * 8 / 32; q++) {
            const int g = 32 * q + t, k = g >> 3, w = g & 7;
            // a square past the last lane loads the last live one again,
            // so every load issues at once (no branch between them)
            const int col = min(base + 4 * w, n - 4);
            const int row = packed_row(4 * k);
            uint32_t v[4];
#pragma unroll
            for (int r = 0; r < 4; r++)
                v[r] = *reinterpret_cast<const uint32_t *>(p + (row + r) * N + col);
            // 4×4 byte transpose: word c gets byte c of v[0..3]
            const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
            const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
            const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
            const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
            tile[4 * w + 0][k] = __byte_perm(lo01, lo23, 0x5410);
            tile[4 * w + 1][k] = __byte_perm(lo01, lo23, 0x7632);
            tile[4 * w + 2][k] = __byte_perm(hi01, hi23, 0x5410);
            tile[4 * w + 3][k] = __byte_perm(hi01, hi23, 0x7632);
        }
    } else if (base + t < n) {
        const uint8_t *col = p + base + t;
#pragma unroll
        for (int k = 0; k < kTileWords; k++) {
            const int row = packed_row(4 * k);
            tile[t][k] = (uint32_t)col[row * N] | (uint32_t)col[(row + 1) * N] << 8 |
                         (uint32_t)col[(row + 2) * N] << 16 | (uint32_t)col[(row + 3) * N] << 24;
        }
    }
}

// Tile rows 8k..8k+7 of one lane as a big-endian 64-bit word
__device__ __forceinline__ uint64_t tile_word(const uint32_t *mine, int k) {
    return (uint64_t)bswap32(mine[2 * k]) << 32 | bswap32(mine[2 * k + 1]);
}

__device__ __forceinline__ uint64_t sigma0(uint64_t x) {
    return rotr64(x, 1) ^ rotr64(x, 8) ^ (x >> 7);
}

__device__ __forceinline__ uint64_t sigma1(uint64_t x) {
    return rotr64(x, 19) ^ rotr64(x, 61) ^ (x >> 6);
}

__global__ void __launch_bounds__(kThreads)
sha512_h_kernel(const uint8_t *p, uint8_t *out, int n, bool words) {
    __shared__ uint64_t wk[80][kLanes];
    __shared__ uint32_t tile[kLanes][kTilePitch];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int base = blockIdx.x * kLanes, i = base + lane;
    const size_t N = (size_t)n;
    const bool live = i < n;
    // issued ahead of the tile's loads: no load waits behind another
    const int flag = live ? p[kRowFlag * N + i] : 0;
    const int mlen = live && warp == 0 ? p[kRowMlen * N + i] : 0;
    STAMP(0)
    uint64_t w[16];
    if (warp == 0) {
        load_tile(p, N, n, base, words, tile);
        __syncwarp();
        STAMP(1)
        const uint32_t *mine = tile[lane];
        // the padded block of R ‖ A ‖ M
#pragma unroll
        for (int t = 0; t < 4; t++) {
            w[t] = tile_word(mine, 4 + t);  // R: tile rows 32:64
            w[4 + t] = tile_word(mine, t);  // A: tile rows 0:32
        }
#pragma unroll
        for (int t = 8; t < 14; t++) {
            const int keep = mlen - 8 * (t - 8);  // message bytes in this word
            const uint64_t mask = keep >= 8 ? ~0ull : keep <= 0 ? 0ull : ~0ull << (64 - 8 * keep);
            const uint64_t pad = keep >= 0 && keep < 8 ? 0x80ull << (56 - 8 * keep) : 0ull;
            w[t] = (tile_word(mine, t) & mask) | pad;
        }
        w[14] = 0;
        w[15] = (uint64_t)(mlen + 64) * 8;  // bytes 126..127: the bit length
#pragma unroll
        for (int t = 0; t < 16; t++) wk[t][lane] = w[t] + kK512[t];
        STAMP(2)
    }
    // every read of rows 0:145 is behind this barrier
    const bool any = __syncthreads_or(live && flag != 0);
    STAMP(3)
    uint64_t a = kIV512[0], b = kIV512[1], c = kIV512[2], d = kIV512[3];
    uint64_t e = kIV512[4], f = kIV512[5], g = kIV512[6], hh = kIV512[7];
    if (any) {
#pragma unroll 1
        for (int s = 0; s < 5; s++) {
            if (warp == 0) {
                if (s < 4) {
#pragma unroll
                    for (int j = 0; j < 16; j++) {
                        // w[j] holds W[t − 16]; W[t] = σ1(W[t−2]) + W[t−7] + σ0(W[t−15]) + W[t−16]
                        w[j] += sigma0(w[(j + 1) & 15]) + w[(j + 9) & 15] + sigma1(w[(j + 14) & 15]);
                        wk[16 * (s + 1) + j][lane] = w[j] + kK512[16 * (s + 1) + j];
                    }
                }
            } else {
                // 8 rounds a pass: the state comes back to its names, and a
                // short loop body is fetched once, not 16 rounds of it
#pragma unroll 1
                for (int t = 16 * s; t < 16 * s + 16; t += 8) {
#pragma unroll
                    for (int j = 0; j < 8; j++) {
                        const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
                        const uint64_t ch = (e & f) ^ (~e & g);
                        const uint64_t t1 = hh + S1 + ch + wk[t + j][lane];
                        const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
                        const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
                        hh = g; g = f; f = e; e = d + t1;
                        d = c; c = b; b = a; a = t1 + S0 + mj;
                    }
                }
            }
            STAMP(4 + s)
            if (s < 4) {
                __syncthreads();
                STAMP(9 + s)
            }
        }
    }
    if (warp == 0 && live && flag == 0) {
        // the host h (rows 96:128 = tile rows 64:96) through
#pragma unroll
        for (int k = 0; k < 32; k++)
            out[k * N + i] = (uint8_t)(tile[lane][16 + k / 4] >> (8 * (k & 3)));
    }
    STAMP(13)
    if (warp == 0 || !live || flag == 0) return;
    const uint64_t h[8] = {kIV512[0] + a, kIV512[1] + b, kIV512[2] + c, kIV512[3] + d,
                           kIV512[4] + e, kIV512[5] + f, kIV512[6] + g, kIV512[7] + hh};
    // the digest bytes (words big-endian) as a little-endian number
    uint32_t x[16];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        x[2 * k] = bswap32((uint32_t)(h[k] >> 32));
        x[2 * k + 1] = bswap32((uint32_t)h[k]);
    }
    uint32_t r[8];
    mod_l(x, r);
#pragma unroll
    for (int k = 0; k < 32; k++) out[k * N + i] = (uint8_t)(r[k >> 2] >> (8 * (k & 3)));
    STAMP(14)
}

// An empty kernel: the floor of one launch, for timing
__global__ void noop_kernel() {}

// dh_rows_to_cols_kernel: the device-hash chunk's transpose.  The host
// stage (native/sighash.c stage_rows) writes a chunk item-major, lane j's
// 160-byte row at rows + 160·j: spread over the 160 rows of the (160, N)
// layout, each lane's bytes cost the host more than the rest of its
// stage.  This kernel turns the uploaded (N, 160) buffer into the (160, N)
// layout that sha512_h_kernel and csrc/ed25519_verify.cu read.  It
// replaces no TPU kernel: the JAX package's host stage writes the (160, N)
// layout itself.  Bound: bytes, 160 read and 160 written a lane (≈ 3.1 µs
// at a 32,768-lane chunk at 3.35 TB/s); no arithmetic to speak of.
//
// A block of 256 threads takes 128 lanes.  Where N % 4 == 0 and the
// pointers are aligned (every chunk width the verify plane makes past
// its ragged tails), it reads them as 16-byte loads, neighbouring
// threads on neighbouring addresses, into a shared tile of 41 words a
// lane (an odd pitch); then a thread takes 4 lanes × 4 rows: it reads the
// 4 lanes' words of those rows (a warp's 32 threads take 8 lane groups ×
// 4 words, so its reads fall on 32 banks), transposes the 4×4 bytes with
// 8 byte permutes and writes one word a row, so a warp writes 4 rows × 32
// bytes, whole sectors.  Otherwise it moves single bytes, neighbouring
// threads on neighbouring bytes of the input and then of an output row.
constexpr int kRows = 160;
constexpr int kTrLanes = 128;
constexpr int kTrThreads = 256;
constexpr int kTrWords = kRows / 4;     // a lane's row in words
constexpr int kTrPitch = kTrWords + 1;  // odd: see the reads above

__global__ void __launch_bounds__(kTrThreads)
dh_rows_to_cols_kernel(const uint8_t *__restrict__ rows, uint8_t *__restrict__ cols, int n,
                       bool words) {
    __shared__ uint32_t tile[kTrLanes * kTrPitch];
    uint8_t *const tile_b = reinterpret_cast<uint8_t *>(tile);
    const int lane0 = blockIdx.x * kTrLanes;
    const int live = min(kTrLanes, n - lane0);
    const uint8_t *const src = rows + (size_t)lane0 * kRows;
    if (words) {
        const uint4 *const src4 = reinterpret_cast<const uint4 *>(src);
        for (int q = threadIdx.x; q < live * (kRows / 16); q += kTrThreads) {
            const uint4 v = src4[q];
            uint32_t *const d = &tile[(q / (kRows / 16)) * kTrPitch + (q % (kRows / 16)) * 4];
            d[0] = v.x;
            d[1] = v.y;
            d[2] = v.z;
            d[3] = v.w;
        }
    } else {
        for (int q = threadIdx.x; q < live * kRows; q += kTrThreads)
            tile_b[(q / kRows) * 4 * kTrPitch + q % kRows] = src[q];
    }
    __syncthreads();
    if (words) {
        const int n4 = n / 4;  // words of an output row
        uint32_t *const dst = reinterpret_cast<uint32_t *>(cols + lane0);
        for (int p = threadIdx.x; p < (kTrLanes / 4) * kTrWords; p += kTrThreads) {
            // a warp's 32 p: lane groups g = 8·g_hi + (p & 7), words
            // w = 4·w_hi + (p >> 3 & 3); banks 4·(p & 7) + (p >> 3 & 3) + const
            const int g = (p >> 5 & 3) * 8 + (p & 7);
            const int w = (p >> 7) * 4 + (p >> 3 & 3);
            if (4 * g >= live) continue;
            const uint32_t *const s = &tile[4 * g * kTrPitch + w];
            const uint32_t a = s[0], b = s[kTrPitch], c = s[2 * kTrPitch], d = s[3 * kTrPitch];
            const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
            const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
            uint32_t *const o = dst + (size_t)(4 * w) * n4 + g;
            o[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
            o[n4] = __byte_perm(ab_lo, cd_lo, 0x7632);
            o[2 * (size_t)n4] = __byte_perm(ab_hi, cd_hi, 0x5410);
            o[3 * (size_t)n4] = __byte_perm(ab_hi, cd_hi, 0x7632);
        }
    } else {
        // live lanes only: a narrow launch (one lane, at consensus) is a
        // single pass of 160 threads
        for (int q = threadIdx.x; q < kRows * live; q += kTrThreads) {
            const int r = q / live, l = q - r * live;
            cols[(size_t)r * n + lane0 + l] = tile_b[l * 4 * kTrPitch + r];
        }
    }
}

static_assert(kMaxMsg == 47, "block assembly covers message bytes 0..47");
static_assert(kRows % 16 == 0 && kRowFlag < kRows, "a lane's row is whole 16-byte loads");
static_assert(kTileWords * 4 == 64 + kMaxMsg + 1, "the tile holds rows 0:64 and 96:144");

}  // namespace

// Launch over n lanes of the packed (160, n) chunk on `stream`, writing
// (32, n) h rows at `out` (row stride n; out may be packed + 96·n).
// Returns cudaGetLastError() (0 on success).  Allocates nothing, does not
// sync.
extern "C" int sha512_h_launch(const void *packed, void *out, int n, void *stream) {
    if (n <= 0) return 0;
    const bool words = n % 4 == 0 && (uintptr_t)packed % 4 == 0;
    const int blocks = (n + kLanes - 1) / kLanes;
    sha512_h_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (uint8_t *)out, n, words);
    return (int)cudaGetLastError();
}

// Launch the transpose over n lanes on `stream`: the (n, 160) item-major
// rows at `rows` into the (160, n) layout at `cols` (a buffer of its own).
// Returns cudaGetLastError() (0 on success).  Allocates nothing, does not
// sync.
extern "C" int dh_rows_to_cols_launch(const void *rows, void *cols, int n, void *stream) {
    if (n <= 0) return 0;
    const bool words = n % 4 == 0 && (uintptr_t)rows % 16 == 0 && (uintptr_t)cols % 4 == 0;
    dh_rows_to_cols_kernel<<<(n + kTrLanes - 1) / kTrLanes, kTrThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)rows, (uint8_t *)cols, n, words);
    return (int)cudaGetLastError();
}

// Launch the empty kernel on `stream` (one block of one warp).
extern "C" int sha512_h_noop_launch(void *stream) {
    noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

#ifdef SHA512_H_STAMPS
// Copy block 0's stamps of the last launch to `host` ([2][16] cycles,
// 0 where a warp took no stamp) and clear them; synchronises the device.
extern "C" int sha512_h_stamps(long long *host) {
    static const long long zero[2][16] = {};
    cudaDeviceSynchronize();
    cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
    cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
    return (int)cudaGetLastError();
}
#endif

extern "C" const char *sha512_h_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
