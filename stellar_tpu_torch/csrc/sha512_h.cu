// sha512_h.cu — h = SHA-512(R‖A‖M) mod L per lane on Hopper: the device-hash
// stage of the verify plane.
//
// Replaces the TPU kernel stellar_tpu/ops/sha512.py::sha512_pallas (body
// _sha_kernel → _h_rows; XLA twin h_rows_from_packed).  The plain PyTorch
// version beside it is stellar_tpu_torch/ops/sha512.py::h_rows_from_packed;
// the wrapper is stellar_tpu_torch/ops/sha512_cuda.py.
//
// Input: the packed (160, N) uint8 device-hash staging chunk, one lane per
// column (ops/sha512.py): rows 0:32 A, 32:64 R, 64:96 s, 96:144 M (raw
// message, mlen ≤ 47) or a host h in 96:128, row 144 mlen, row 145 flag.
// Output: (32, N) uint8 h rows, little-endian, written at `out` with row
// stride N.  A flag ≠ 0 lane hashes the single padded 128-byte block of
// R‖A‖M (80 rounds) and reduces the 512-bit digest mod L; a flag = 0 lane
// writes its uploaded h (rows 96:128) through unchanged.
//
// In place: the verify plane passes out = packed + 96·N, so h lands in
// rows 96:128 of the uploaded tensor and its first 128 rows are the
// (128, N) layout csrc/ed25519_verify.cu reads — no copy, no concat.  A
// flag ≠ 0 lane's rows 96:128 hold its first 32 message bytes, so every
// thread reads all of its lane's rows (0:64 and 96:146) into registers
// before it writes any h row; a thread touches only its own column, so no
// other lane's reads can see its writes.  Hence no __restrict__ on p/out.
//
// Design (simple and correct first):
// - one thread per lane; thread i reads byte row r at p[r·N + i], so a
//   warp's loads are coalesced; the ragged tail is masked;
// - SHA-512 words are uint64_t (the TPU's hi/lo int32 pairs existed only
//   because the TPU has no 64-bit lanes); the 80 rounds and the rolling
//   16-word schedule are fully unrolled, so the schedule and the round
//   constants live in registers and constant-bank operands;
// - mod L is the JAX kernel's branch-free fold at 2^252 against
//   c = L − 2^252, on 32-bit limbs with 64-bit products: four folds, each
//   adding a precomputed multiple K of L that covers the B·c it subtracts,
//   then one conditional subtract of L (bounds at mod_l below).
//
// Bound: integer operations, counted from this source per flag ≠ 0 lane in
// 32-bit instructions (a 64-bit rotate or shift is two funnel shifts, a
// 3-input xor/choice/majority one LOP3 per half, a 3-term 64-bit add two
// IADD3s, a 32×32→64 multiply-add with its carry add 4):
//   - 80 rounds × 28 (Σ1 8, Ch 2, T1 4, Σ0 8, Maj 2, e 2, a 2) = 2240;
//   - 64 schedule words × 20 (σ0 8, σ1 8, sum 4) = 1280;
//   - feed-forward 16; block assembly 210 (112 loaded bytes merged, 2 per
//     message byte for the padding select, the length word);
//   - mod L 510 (72 limb products × 4, B extraction 36, A + K − T 114,
//     compare and subtract 24, digest byte swaps 16, h bytes 32);
// 4256 a lane, ≈ 0.25 ns a lane on an H100 SXM (132 SMs × 64 INT32 lanes
// × 1.98 GHz).  Bytes: 114 read and 32 written a hashed lane, 33 and 32 a
// passthrough lane.  chip_smoke.py computes the bound from each run's
// lanes; at the verify plane's 4096-lane chunk it is ~1 µs, so a launch
// costs its launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowM = 96;
constexpr int kRowMlen = 144;
constexpr int kRowFlag = 145;
constexpr int kMaxMsg = 47;
constexpr int kThreads = 128;

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

__device__ __forceinline__ uint32_t bswap32(uint32_t v) {
    return (v >> 24) | ((v >> 8) & 0xff00u) | ((v << 8) & 0xff0000u) | (v << 24);
}

// SHA-512 of one padded block from the IV: the 8 digest words
__device__ __forceinline__ void sha512_block(uint64_t w[16], uint64_t h[8]) {
    uint64_t a = kIV512[0], b = kIV512[1], c = kIV512[2], d = kIV512[3];
    uint64_t e = kIV512[4], f = kIV512[5], g = kIV512[6], hh = kIV512[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        if (t >= 16) {
            const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
            const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        const uint64_t ch = (e & f) ^ (~e & g);
        const uint64_t t1 = hh + S1 + ch + kK512[t] + w[t & 15];
        const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + mj;
    }
    h[0] = kIV512[0] + a; h[1] = kIV512[1] + b; h[2] = kIV512[2] + c;
    h[3] = kIV512[3] + d; h[4] = kIV512[4] + e; h[5] = kIV512[5] + f;
    h[6] = kIV512[6] + g; h[7] = kIV512[7] + hh;
}

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
    uint32_t t[NB + 4];
#pragma unroll
    for (int j = 0; j < NB + 4; j++) t[j] = 0;
#pragma unroll
    for (int r = 0; r < NB; r++) {
        uint64_t carry = 0;
#pragma unroll
        for (int s = 0; s < 4; s++) {
            const uint64_t v = (uint64_t)b[r] * kC[s] + t[r + s] + carry;
            t[r + s] = (uint32_t)v;
            carry = v >> 32;
        }
        t[r + 4] = (uint32_t)carry;
    }
    int64_t acc = 0;
#pragma unroll
    for (int j = 0; j < NY; j++) {
        int64_t v = acc + (int64_t)k[j];
        if (j < 7) v += x[j];
        if (j == 7) v += x[7] & 0x0fffffffu;
        if (j < NB + 4) v -= t[j];
        y[j] = (uint32_t)v;
        acc = (v - (int64_t)(uint32_t)v) / 4294967296ll;  // exact floor
    }
}

// The 512-bit value x (16 little-endian limbs) mod L, as 8 limbs:
//   fold 1: B < 2^260, B·c < 2^385 ≤ K1 < 2^386  → y1 < 2^387 (13 limbs)
//   fold 2: B < 2^135, B·c < 2^260 ≤ K2 < 2^261  → y2 < 2^262 (9 limbs)
//   fold 3: B < 2^10,  B·c < 2^135 < L = K       → y3 < 2^254 (8 limbs)
//   fold 4: B < 4,     B·c < 2^127 < L = K       → y4 < 2^252 + L < 2L
//   then y4 − L if y4 ≥ L.
__device__ __forceinline__ void mod_l(const uint32_t (&x)[16], uint32_t (&r)[8]) {
    uint32_t y1[13], y2[9], y3[8];
    fold252<16, 13>(x, kK1, y1);
    fold252<13, 9>(y1, kK2, y2);
    fold252<9, 8>(y2, kL, y3);
    fold252<8, 8>(y3, kL, r);
    bool ge = true;  // r >= L, compared from the top limb
    bool decided = false;
#pragma unroll
    for (int j = 7; j >= 0; j--) {
        if (!decided && r[j] != kL[j]) {
            ge = r[j] > kL[j];
            decided = true;
        }
    }
    if (ge) {
        int64_t acc = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const int64_t v = acc + (int64_t)r[j] - (int64_t)kL[j];
            r[j] = (uint32_t)v;
            acc = (v - (int64_t)(uint32_t)v) / 4294967296ll;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
sha512_h_kernel(const uint8_t *p, uint8_t *out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    if (p[kRowFlag * N + i] == 0) {
#pragma unroll
        for (int k = 0; k < 32; k++) out[k * N + i] = p[(kRowM + k) * N + i];
        return;
    }
    // the padded block of R ‖ A ‖ M, read whole before any write
    const int mlen = p[kRowMlen * N + i];
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 8; t++) {
        const int row0 = t < 4 ? 32 + 8 * t : 8 * (t - 4);  // R, then A
        uint64_t v = 0;
#pragma unroll
        for (int b = 0; b < 8; b++) v = (v << 8) | p[(row0 + b) * N + i];
        w[t] = v;
    }
#pragma unroll
    for (int t = 8; t < 14; t++) {
        uint64_t v = 0;
#pragma unroll
        for (int b = 0; b < 8; b++) {
            const int j = 8 * (t - 8) + b;  // message byte 0..47
            const uint32_t m = j < mlen ? p[(kRowM + j) * N + i] : (j == mlen ? 0x80u : 0u);
            v = (v << 8) | m;
        }
        w[t] = v;
    }
    w[14] = 0;
    w[15] = (uint64_t)(mlen + 64) * 8;  // bytes 126..127: the bit length
    uint64_t h[8];
    sha512_block(w, h);
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
}

static_assert(kMaxMsg == 47, "block assembly covers message bytes 0..47");

}  // namespace

// Launch over n lanes of the packed (160, n) chunk on `stream`, writing
// (32, n) h rows at `out` (row stride n; out may be packed + 96·n).
// Returns cudaGetLastError() (0 on success).  Allocates nothing, does not
// sync.
extern "C" int sha512_h_launch(const void *packed, void *out, int n, void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    sha512_h_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (uint8_t *)out, n);
    return (int)cudaGetLastError();
}

extern "C" const char *sha512_h_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
