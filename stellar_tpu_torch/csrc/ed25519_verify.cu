// ed25519_verify.cu — batched cofactorless ed25519 verification on Hopper.
//
// Replaces the TPU kernel stellar_tpu/ops/ed25519_pallas.py::
// verify_kernel_pallas (and computes what its XLA twin
// stellar_tpu/ops/ed25519.py::verify_kernel computes).  The plain PyTorch
// version beside it is stellar_tpu_torch/ops/ed25519.py::_verify_packed;
// the wrapper is stellar_tpu_torch/ops/ed25519_cuda.py.
//
// Input: the packed (128, N) uint8 staging chunk, one lane per column —
// rows 0:32 A, 32:64 R, 64:96 s, 96:128 h = SHA-512(R‖A‖M) mod L, all
// little-endian.  Output: (N,) uint8, 1 iff R == enc(s·B + h·(−A)) and A
// decompressed.  Raw lanes the host gate would reject get the plain
// version's verdict too: y >= p decodes as the 255-bit value mod p, s >= L
// runs unsigned 4-bit windows over all 256 bits (the modular result), an
// undecompressable A fails, and torsion-proof lanes (A := P, s := 0,
// h := L, R := identity encoding) compute [L]·P.
//
// Design (simple and correct first):
// - one thread per lane; thread i reads byte row r at p[r*N + i], so a
//   warp's loads are coalesced; the ragged tail is masked;
// - field elements are 10 signed 32-bit limbs in radix 2^25.5 (ref10's
//   layout), products are 32x32->64 multiply-adds summed in int64, and
//   every add/sub is carried back to limbs < 2^26 so product columns stay
//   far below 2^63;
// - verification handles public data only, so table loads use variable
//   indices: the per-lane table of k·(−A), k = 0..15 (16 niels points,
//   2.5 KB) lives in local memory; the fixed-base table of k·B comes from
//   the wrapper (built from the port's ref25519) into shared memory;
// - Z is inverted per lane by Fermat (z^(p-2)).
//
// Bound: 3498 field operations per verify, counted from this algorithm
// (the JAX kernel's): 1533 squarings and 1965 multiplications.
//   - 64 windows × (16S + 28M): 4 doublings of 4S + 3M (the last 4M, it
//     makes T), a fixed-base niels add 8M, a dynamic niels add 7M;
//   - the table of k·(−A): 142M (14 general adds of 9M, 15 × 2d·T, −A's T);
//   - decompress: 255S + 18M (pow_p58's chain 251S + 11M), not counting
//     the √−1 fix-up, which only some lanes take;
//   - compress: 254S + 13M (the Fermat inversion 254S + 11M, then X/Z, Y/Z).
// As 32-bit integer multiply-adds (IMAD, low and high half each) on a
// 255-bit value held in 8 words: a product is 8×8 word products, 128
// IMADs; a squaring 36 distinct word products, 72 IMADs; the reduction
// folds the 8 high words ×38 into the low 8, 16 IMADs more.  So 144 per
// multiplication and 88 per squaring, 417,864 IMADs per verify; additions
// and carries are not counted, so this stays a lower bound.  On an H100
// SXM (132 SMs × 64 INT32 lanes × 1.98 GHz ≈ 16.7e12 IMAD/s) that is
// ≈ 25 ns per verify — the kernel is bound by integer operations; its
// 129 bytes per lane are ~1e-3 of that time at 3.35 TB/s.  chip_smoke.py
// computes this bound from each run's inputs and prints it beside the
// measured time.
//
// What this simple design leaves on the table: the 10-limb schoolbook
// product spends 100 IMAD.WIDE where a 64-bit-limb or tensor-core scheme
// needs fewer; add/sub carry eagerly; the dynamic table sits in local
// memory (L1 traffic on every window); signed windows (half the table,
// half the adds' table build), a shared inversion across the block, and
// ILP across two lanes per thread are all not done.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fe {
    int32_t v[10];
};

struct Pt {
    Fe X, Y, Z, T;
};

struct Niels {
    Fe ypx, ymx, t2d, z2;
};

// limb i holds bits [OFF(i), OFF(i) + BITS(i)) of the 255-bit value
__host__ __device__ constexpr int BITS(int i) { return (i & 1) ? 25 : 26; }
__host__ __device__ constexpr int OFF(int i) { return (i * 51 + 1) / 2; }

// Sequential floor carry: limbs land in [0, 2^BITS) except limb 1, which
// may exceed 2^25 by the folded carry (< 2^16); the overflow of limb 9
// folds into limb 0 through 2^255 ≡ 19 (mod p).  T is int32 for sums and
// int64 for product columns; both are non-negative on entry.
template <typename T>
__device__ __forceinline__ Fe carry(T h[10]) {
#pragma unroll
    for (int i = 0; i < 9; i++) {
        T c = h[i] >> BITS(i);
        h[i] -= c << BITS(i);
        h[i + 1] += c;
    }
    T c = h[9] >> 25;
    h[9] -= c << 25;
    h[0] += c * 19;
    c = h[0] >> 26;
    h[0] -= c << 26;
    h[1] += c;
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
    return r;
}

__device__ __forceinline__ Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = 0;
    return r;
}

__device__ __forceinline__ Fe fe_one() {
    Fe r = fe_zero();
    r.v[0] = 1;
    return r;
}

__device__ __forceinline__ Fe fe_add(const Fe &a, const Fe &b) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = a.v[i] + b.v[i];
    return carry(h);
}

// a + 2p - b: every limb of 2p exceeds the matching limb of a carried b,
// so the sum has no negative limb
__device__ __forceinline__ Fe fe_sub(const Fe &a, const Fe &b) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        int32_t two_p = (i == 0) ? (1 << 27) - 38 : (2 << BITS(i)) - 2;
        h[i] = a.v[i] + two_p - b.v[i];
    }
    return carry(h);
}

__device__ __forceinline__ Fe fe_neg(const Fe &a) { return fe_sub(fe_zero(), a); }

__device__ __forceinline__ Fe fe_mul2(const Fe &a) { return fe_add(a, a); }

// Schoolbook product.  Limb i·j lands at weight 2^(OFF(i)+OFF(j)), which is
// 2^OFF(i+j) times 2 when both i and j are odd; columns i+j >= 10 fold ×19.
// f2 = 2f (odd limbs) and g19 = 19g stay below 2^31 for carried inputs.
__device__ __forceinline__ Fe fe_mul(const Fe &f, const Fe &g) {
    int32_t g19[10];
#pragma unroll
    for (int j = 0; j < 10; j++) g19[j] = 19 * g.v[j];
    int64_t h[10];
#pragma unroll
    for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = 0; j < 10; j++) {
            int32_t a = ((i & 1) && (j & 1)) ? 2 * f.v[i] : f.v[i];
            int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
            h[(i + j) % 10] += (int64_t)a * b;
        }
    }
    return carry(h);
}

__device__ __forceinline__ Fe fe_sq(const Fe &f) {
    int64_t h[10];
#pragma unroll
    for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            int32_t a = f.v[i];
            if ((i & 1) && (j & 1)) a *= 2;
            if (i != j) a *= 2;
            int32_t b = (i + j >= 10) ? 19 * f.v[j] : f.v[j];
            h[(i + j) % 10] += (int64_t)a * b;
        }
    }
    return carry(h);
}

__device__ __noinline__ Fe fe_sq_n(Fe f, int n) {
#pragma unroll 1
    for (int k = 0; k < n; k++) f = fe_sq(f);
    return f;
}

// z^(2^250 - 1) and z^11 — the shared prefix of the inversion and the
// square-root exponentiation chains
__device__ __noinline__ void pow_core(const Fe &z, Fe &t250, Fe &z11) {
    Fe t0 = fe_sq(z);                      // 2
    Fe t1 = fe_mul(z, fe_sq_n(t0, 2));     // 9
    t0 = fe_mul(t0, t1);                   // 11
    z11 = t0;
    Fe t2 = fe_sq(t0);                     // 22
    t1 = fe_mul(t1, t2);                   // 2^5 - 1
    t2 = fe_sq_n(t1, 5);
    t1 = fe_mul(t1, t2);                   // 2^10 - 1
    t2 = fe_mul(fe_sq_n(t1, 10), t1);      // 2^20 - 1
    Fe t3 = fe_mul(fe_sq_n(t2, 20), t2);   // 2^40 - 1
    t2 = fe_mul(fe_sq_n(t3, 10), t1);      // 2^50 - 1
    t3 = fe_mul(fe_sq_n(t2, 50), t2);      // 2^100 - 1
    Fe t4 = fe_mul(fe_sq_n(t3, 100), t3);  // 2^200 - 1
    t250 = fe_mul(fe_sq_n(t4, 50), t2);    // 2^250 - 1
}

__device__ Fe fe_invert(const Fe &z) {  // z^(p-2)
    Fe t250, z11;
    pow_core(z, t250, z11);
    return fe_mul(fe_sq_n(t250, 5), z11);
}

__device__ Fe fe_pow_p58(const Fe &z) {  // z^((p-5)/8)
    Fe t250, z11;
    pow_core(z, t250, z11);
    return fe_mul(fe_sq_n(t250, 2), z);
}

// Fully reduced value (< p) as four little-endian 64-bit words.
__device__ void fe_words(const Fe &f, uint64_t w[4]) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = f.v[i];
    // two carry passes leave every limb exact and the value < 2^255
#pragma unroll
    for (int pass = 0; pass < 2; pass++) {
#pragma unroll
        for (int i = 0; i < 9; i++) {
            int32_t c = h[i] >> BITS(i);
            h[i] -= c << BITS(i);
            h[i + 1] += c;
        }
        int32_t c = h[9] >> 25;
        h[9] -= c << 25;
        h[0] += 19 * c;
    }
    // value >= p iff value + 19 carries out of bit 255; then the result is
    // value + 19 - 2^255
    int32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = h[i];
    t[0] += 19;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        int32_t c = t[i] >> BITS(i);
        t[i] -= c << BITS(i);
        t[i + 1] += c;
    }
    const bool ge_p = (t[9] >> 25) != 0;
    t[9] &= (1 << 25) - 1;
#pragma unroll
    for (int k = 0; k < 4; k++) w[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const uint64_t l = (uint64_t)(uint32_t)(ge_p ? t[i] : h[i]);
        const int off = OFF(i), k = off >> 6, s = off & 63;
        w[k] |= l << s;
        if (s + BITS(i) > 64) w[k + 1] |= l >> (64 - s);
    }
}

__device__ __forceinline__ bool fe_is_zero(const Fe &f) {
    uint64_t w[4];
    fe_words(f, w);
    return (w[0] | w[1] | w[2] | w[3]) == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe &a, const Fe &b) {
    return fe_is_zero(fe_sub(a, b));
}

__device__ __forceinline__ int fe_parity(const Fe &f) {
    uint64_t w[4];
    fe_words(f, w);
    return (int)(w[0] & 1);
}

// 255-bit little-endian value (bit 255 already dropped by the caller)
__device__ Fe fe_from_words(const uint64_t w[4]) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int off = OFF(i), k = off >> 6, s = off & 63;
        uint64_t v = w[k] >> s;
        if (s + BITS(i) > 64) v |= w[k + 1] << (64 - s);
        r.v[i] = (int32_t)(v & ((1ull << BITS(i)) - 1));
    }
    return r;
}

// --- point arithmetic: extended coordinates, a = −1, complete formulas ---

__device__ __forceinline__ Pt pt_identity() {
    Pt p;
    p.X = fe_zero();
    p.Y = fe_one();
    p.Z = fe_one();
    p.T = fe_zero();
    return p;
}

// general extended + extended (add-2008-hwcd-3 shape), d2 = 2d
__device__ Pt pt_add(const Pt &p, const Pt &q, const Fe &d2) {
    Fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    Fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    Fe c = fe_mul(fe_mul(p.T, q.T), d2);
    Fe d = fe_mul2(fe_mul(p.Z, q.Z));
    Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
    Pt r;
    r.X = fe_mul(e, f);
    r.Y = fe_mul(g, h);
    r.Z = fe_mul(f, g);
    r.T = fe_mul(e, h);
    return r;
}

template <bool NEED_T>
__device__ __forceinline__ Pt pt_add_niels(const Pt &p, const Niels &n) {
    Fe a = fe_mul(fe_sub(p.Y, p.X), n.ymx);
    Fe b = fe_mul(fe_add(p.Y, p.X), n.ypx);
    Fe c = fe_mul(p.T, n.t2d);
    Fe d = fe_mul(p.Z, n.z2);
    Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
    Pt r;
    r.X = fe_mul(e, f);
    r.Y = fe_mul(g, h);
    r.Z = fe_mul(f, g);
    r.T = NEED_T ? fe_mul(e, h) : fe_zero();
    return r;
}

// dbl-2008-hwcd with a = −1; only a doubling that feeds an addition makes T
template <bool NEED_T>
__device__ __forceinline__ Pt pt_double(const Pt &p) {
    Fe a = fe_sq(p.X);
    Fe b = fe_sq(p.Y);
    Fe c = fe_mul2(fe_sq(p.Z));
    Fe d = fe_neg(a);
    Fe e = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), a), b);
    Fe g = fe_add(d, b);
    Fe f = fe_sub(g, c);
    Fe h = fe_sub(d, b);
    Pt r;
    r.X = fe_mul(e, f);
    r.Y = fe_mul(g, h);
    r.Z = fe_mul(f, g);
    r.T = NEED_T ? fe_mul(e, h) : fe_zero();
    return r;
}

__device__ __forceinline__ Niels to_niels(const Pt &p, const Fe &d2) {
    Niels n;
    n.ypx = fe_add(p.Y, p.X);
    n.ymx = fe_sub(p.Y, p.X);
    n.t2d = fe_mul(p.T, d2);
    n.z2 = fe_mul2(p.Z);
    return n;
}

// 32 little-endian bytes of rows [row0, row0 + 32) of lane i as 64-bit words
__device__ __forceinline__ void load_words(const uint8_t *__restrict__ p, int n,
                                           int i, int row0, uint64_t w[4]) {
#pragma unroll
    for (int k = 0; k < 4; k++) {
        uint64_t v = 0;
#pragma unroll
        for (int b = 0; b < 8; b++)
            v |= (uint64_t)p[(size_t)(row0 + 8 * k + b) * n + i] << (8 * b);
        w[k] = v;
    }
}

// constant block from the wrapper: the fixed-base niels table of k·B,
// k = 0..15 (16 × 4 field elements), then d, 2d and sqrt(−1)
constexpr int kBaseInts = 16 * 4 * 10;
constexpr int kConstInts = kBaseInts + 3 * 10;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ed25519_verify_kernel(const uint8_t *__restrict__ p, uint8_t *__restrict__ out,
                      int n, const int32_t *__restrict__ consts) {
    __shared__ Niels base[16];
    __shared__ Fe cst[3];
    int32_t *sb = reinterpret_cast<int32_t *>(base);
    int32_t *sc = reinterpret_cast<int32_t *>(cst);
    for (int k = threadIdx.x; k < kBaseInts; k += blockDim.x) sb[k] = consts[k];
    for (int k = threadIdx.x; k < 30; k += blockDim.x) sc[k] = consts[kBaseInts + k];
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Fe D = cst[0], D2 = cst[1], SQRT_M1 = cst[2];

    // decompress A (ref25519.decompress, with y taken mod p)
    uint64_t aw[4];
    load_words(p, n, i, 0, aw);
    const int sign = (int)(aw[3] >> 63);
    aw[3] &= 0x7fffffffffffffffull;
    const Fe y = fe_from_words(aw);
    const Fe one = fe_one();
    const Fe yy = fe_sq(y);
    const Fe u = fe_sub(yy, one);
    const Fe v = fe_add(fe_mul(yy, D), one);
    const Fe v3 = fe_mul(fe_sq(v), v);
    const Fe v7 = fe_mul(fe_sq(v3), v);
    Fe x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
    const Fe vxx = fe_mul(v, fe_sq(x));
    const bool ok1 = fe_eq(vxx, u);
    const bool ok2 = fe_eq(vxx, fe_neg(u));
    if (ok2) x = fe_mul(x, SQRT_M1);
    const bool fail = !(ok1 || ok2) || (fe_is_zero(x) && sign == 1);
    if (fe_parity(x) != sign) x = fe_neg(x);

    // −A and its niels table k·(−A), k = 0..15 (local memory)
    Pt neg_a;
    neg_a.X = fe_neg(x);
    neg_a.Y = y;
    neg_a.Z = one;
    neg_a.T = fe_neg(fe_mul(x, y));
    Niels tab[16];
    tab[0].ypx = one;
    tab[0].ymx = one;
    tab[0].t2d = fe_zero();
    tab[0].z2 = fe_add(one, one);
    Pt q = neg_a;
#pragma unroll 1
    for (int k = 1; k < 16; k++) {
        tab[k] = to_niels(q, D2);
        if (k < 15) q = pt_add(q, neg_a, D2);
    }

    // Straus: R' = s·B + h·(−A), 4-bit unsigned windows from the top
    uint64_t sw[4], hw[4];
    load_words(p, n, i, 64, sw);
    load_words(p, n, i, 96, hw);
    Pt acc = pt_identity();
#pragma unroll 1
    for (int t = 63; t >= 0; t--) {
        acc = pt_double<false>(acc);
        acc = pt_double<false>(acc);
        acc = pt_double<false>(acc);
        acc = pt_double<true>(acc);
        const int sh = (t & 15) * 4;
        const int s_nib = (int)((sw[t >> 4] >> sh) & 15);
        const int h_nib = (int)((hw[t >> 4] >> sh) & 15);
        acc = pt_add_niels<true>(acc, base[s_nib]);
        acc = pt_add_niels<false>(acc, tab[h_nib]);
    }

    // compress and compare all 32 bytes with R
    const Fe zinv = fe_invert(acc.Z);
    uint64_t yw[4];
    fe_words(fe_mul(acc.Y, zinv), yw);
    yw[3] |= (uint64_t)fe_parity(fe_mul(acc.X, zinv)) << 63;
    uint64_t rw[4];
    load_words(p, n, i, 32, rw);
    const bool match = yw[0] == rw[0] && yw[1] == rw[1] && yw[2] == rw[2] &&
                       yw[3] == rw[3];
    out[i] = (uint8_t)(match && !fail);
}

}  // namespace

// Launch over n lanes of the packed (128, n) chunk on `stream`; returns
// cudaGetLastError() (0 on success).  Allocates nothing, does not sync.
extern "C" int ed25519_verify_launch(const void *packed, void *out, int n,
                                     const void *consts, void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    ed25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (uint8_t *)out, n, (const int32_t *)consts);
    return (int)cudaGetLastError();
}

extern "C" int ed25519_const_ints(void) { return kConstInts; }

extern "C" const char *ed25519_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
