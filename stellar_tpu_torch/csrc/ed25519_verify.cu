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
// Bound: 3498 field operations per verify, counted from the JAX kernel's
// algorithm (the work any implementation of it does, whatever this one
// skips): 1533 squarings and 1965 multiplications.
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
// Design.  One thread per lane left a 4096-lane chunk on 128 warps, one
// dependent chain of ~3500 field operations each: latency, not issue rate,
// set the time.  So:
// - a group of 4 threads runs one signature (4-way parallel extended
//   coordinates).  Every stage of the twisted-Edwards formulas has four
//   independent field products: a doubling X², Y², Z², (X+Y)², then
//   E·F, G·H, F·G, E·H; a niels addition (Y+X)·(y+x), (Y−X)·(y−x),
//   T·2dt, Z·2z, then the same four.  Thread r of the group computes
//   product r, the group all-gathers the four results with
//   __shfl_sync(width 4) (40 shuffles a stage), and each thread does the
//   additions itself.  A window is 12 serial products instead of 44.
//   Thread r picks its operands by selects on r, never by indexing a
//   local array with r.  Lanes are threadIdx.x / 4; a block is 64 threads,
//   16 lanes, so a 4096-lane chunk is 256 blocks, 512 warps;
// - every thread of a warp takes part in every shuffle: the ragged tail
//   clamps its lane index to n − 1, computes, and masks the store; per-lane
//   decisions (the √−1 fix-up, the sign flip) are selects, not branches;
// - the table of k·(−A), k = 0..15, is built as k·(−A) = (k−1)·(−A) +
//   niels(−A) (two stages) and one stage for 2d·T.  In the first stage of a
//   niels addition thread r reads only component r of the entry (of y+x,
//   y−x, 2d·t, 2z), so each thread keeps only its own component: 16 × 40 B
//   = 640 B, in shared memory as [k][limb][thread] (a warp's 32 threads hit
//   32 banks; the [thread][k][limb] order would put a warp's reads of one
//   limb 160 words apart, on one bank).  64 threads × 640 B = 40 KB, plus
//   the fixed-base table (2.5 KB), stays under the 48 KB of static shared
//   memory;
// - no inversion of Z.  The group's odd threads decode R while its even
//   threads decode A (one instruction stream on other data), and the
//   verdict is
//       A decodes ∧ R decodes ∧ R's 255-bit y < p
//         ∧ X_P = x_R·Z_P ∧ Y_P = y_R·Z_P        (P = s·B + h·(−A)),
//   the last two one product stage (thread 1 and thread 3).  This equals
//   enc(P) == R: enc writes a canonical y < p and sign = parity(x), never
//   x = 0 with the sign set; decode refuses x = 0 with the sign set (as
//   ref25519.decompress does) and gives the x of that parity, so a
//   canonical R decodes to P iff it is P's encoding; decode aliases y >= p
//   mod p, so the canonical check on R is explicit; Z_P ≠ 0, as the
//   formulas are complete on the curve (a lane whose A does not decode
//   fails whatever P is).  The 254S + 11M inversion leaves the serial
//   chain, and R's decode runs in the shadow of A's;
// - field elements stay 10 signed 32-bit limbs in radix 2^25.5 (ref10's
//   layout), products 32x32->64 multiply-adds summed in int64, every
//   add/sub carried back to limbs < 2^26 so product columns stay far below
//   2^63; unsigned 4-bit windows (signed digits would need a 65th digit
//   for raw lanes with s >= 2^253); the fixed-base table of k·B comes from
//   the wrapper (built from the port's ref25519) into shared memory.
// Serial chain per lane: ~273 products (decode) + ~45 (table) + 768 (64
// windows × 12) + 1, against 3498 field operations in the one-thread
// design.
//
// What is still left on the table.  At 4096 lanes each scheduler runs at
// most one warp, and a stage issues several hundred instructions a thread
// (100 IMAD.WIDE of the product, the carries, the selects, 40 shuffles, and
// the additions that every thread of the group forms and carries itself).
// A carry in two interleaved chains (7 dependent steps, not 12) and a
// broadcast of X and Y alone after the second stage (20 shuffles, not 40)
// were both measured no faster, so the latency of the chain is likely no
// longer what sets the time, but the issue rate of one warp a scheduler.
// Left: fewer instructions a stage (operands of a product left uncarried, a
// signed select-and-add in place of four additions); the two even threads
// both decoding A; the 10-limb schoolbook product (100 IMAD.WIDE where
// 64-bit limbs or tensor cores need fewer); signed windows (half the
// table).


#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fe {
    int32_t v[10];
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

__device__ __forceinline__ Fe fe_small(int32_t v0) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = 0;
    r.v[0] = v0;
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

__device__ __forceinline__ Fe fe_neg(const Fe &a) { return fe_sub(fe_small(0), a); }

__device__ __forceinline__ Fe fe_sel(bool c, const Fe &a, const Fe &b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = c ? a.v[i] : b.v[i];
    return r;
}

// operand r of four, by selects (no local array indexed by r)
__device__ __forceinline__ Fe fe_sel4(int r, const Fe &a, const Fe &b, const Fe &c,
                                      const Fe &d) {
    Fe o;
#pragma unroll
    for (int i = 0; i < 10; i++)
        o.v[i] = r == 0 ? a.v[i] : r == 1 ? b.v[i] : r == 2 ? c.v[i] : d.v[i];
    return o;
}

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

// z^((p-5)/8) = z^(2^252 - 3)
__device__ __noinline__ Fe fe_pow_p58(Fe z) {
    Fe t0 = fe_sq(z);                      // 2
    Fe t1 = fe_mul(z, fe_sq_n(t0, 2));     // 9
    t0 = fe_mul(t0, t1);                   // 11
    Fe t2 = fe_sq(t0);                     // 22
    t1 = fe_mul(t1, t2);                   // 2^5 - 1
    t2 = fe_sq_n(t1, 5);
    t1 = fe_mul(t1, t2);                   // 2^10 - 1
    t2 = fe_mul(fe_sq_n(t1, 10), t1);      // 2^20 - 1
    Fe t3 = fe_mul(fe_sq_n(t2, 20), t2);   // 2^40 - 1
    t2 = fe_mul(fe_sq_n(t3, 10), t1);      // 2^50 - 1
    t3 = fe_mul(fe_sq_n(t2, 50), t2);      // 2^100 - 1
    Fe t4 = fe_mul(fe_sq_n(t3, 100), t3);  // 2^200 - 1
    t3 = fe_mul(fe_sq_n(t4, 50), t2);      // 2^250 - 1
    return fe_mul(fe_sq_n(t3, 2), z);
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

// ref25519.decompress of the 32 bytes in w, with y taken mod p: returns
// whether the encoding decodes, and x, y.  The √−1 fix-up and the sign
// flip are selects, so threads decoding different points stay converged.
__device__ __forceinline__ bool decode(uint64_t w[4], const Fe &D, const Fe &SQRT_M1,
                                      Fe &x, Fe &y) {
    const int sign = (int)(w[3] >> 63);
    w[3] &= 0x7fffffffffffffffull;
    y = fe_from_words(w);
    const Fe one = fe_small(1);
    const Fe yy = fe_sq(y);
    const Fe u = fe_sub(yy, one);
    const Fe v = fe_add(fe_mul(yy, D), one);
    const Fe v3 = fe_mul(fe_sq(v), v);
    const Fe v7 = fe_mul(fe_sq(v3), v);
    x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
    const Fe vxx = fe_mul(v, fe_sq(x));
    const bool ok1 = fe_eq(vxx, u);
    const bool ok2 = fe_eq(vxx, fe_neg(u));
    x = fe_sel(ok2, fe_mul(x, SQRT_M1), x);
    const bool ok = (ok1 || ok2) && !(fe_is_zero(x) && sign == 1);
    x = fe_sel(fe_parity(x) != sign, fe_neg(x), x);
    return ok;
}

// --- the group of four: extended coordinates, a = −1, complete formulas ---

constexpr int kGroup = 4;     // threads per signature
constexpr int kThreads = 64;  // threads per block: 16 signatures

__device__ __forceinline__ int32_t shfl4(int32_t v, int src) {
    return __shfl_sync(0xffffffffu, v, src, kGroup);
}

__device__ __forceinline__ Fe fe_shfl4(const Fe &a, int src) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = shfl4(a.v[i], src);
    return r;
}

struct Pt {
    Fe X, Y, Z, T;
};

// thread r of the group holds coordinate r; every thread gets all four
__device__ __forceinline__ Pt gather(const Fe &o) {
    Pt p;
    p.X = fe_shfl4(o, 0);
    p.Y = fe_shfl4(o, 1);
    p.Z = fe_shfl4(o, 2);
    p.T = fe_shfl4(o, 3);
    return p;
}

// the second stage of doubling and addition: (E·F, G·H, F·G, E·H)
__device__ __forceinline__ Pt finish(int r, const Fe &e, const Fe &f, const Fe &g,
                                     const Fe &h) {
    return gather(fe_mul(fe_sel4(r, e, g, f, e), fe_sel4(r, f, h, g, h)));
}

// dbl-2008-hwcd with a = −1: A = X², B = Y², C = 2Z², E = (X+Y)² − A − B,
// G = B − A, F = G − C, H = −A − B
__device__ __forceinline__ Pt pt_double(int r, const Pt &p) {
    const Pt q = gather(fe_sq(fe_sel4(r, p.X, p.Y, p.Z, fe_add(p.X, p.Y))));
    const Fe ab = fe_add(q.X, q.Y);
    const Fe g = fe_sub(q.Y, q.X);
    return finish(r, fe_sub(q.T, ab), fe_sub(g, fe_add(q.Z, q.Z)), g, fe_neg(ab));
}

// p + n for a niels point n = (y+x, y−x, 2d·t, 2z), of which this thread
// holds component r: b = (Y+X)(y+x), a = (Y−X)(y−x), c = T·2dt, d = Z·2z,
// then E = b − a, F = d − c, G = d + c, H = b + a
__device__ __forceinline__ Pt pt_add_niels(int r, const Pt &p, const Fe &n_r) {
    const Pt q = gather(fe_mul(fe_sel4(r, fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.T, p.Z), n_r));
    return finish(r, fe_sub(q.X, q.Y), fe_sub(q.T, q.Z), fe_add(q.T, q.Z), fe_add(q.X, q.Y));
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
// k = 0..15 (16 × 4 field elements: y+x, y−x, 2d·t, 2z), then d, 2d and
// sqrt(−1)
constexpr int kBaseInts = 16 * 4 * 10;
constexpr int kConstInts = kBaseInts + 3 * 10;

// Lane i = blockIdx.x · (blockDim.x / 4) + threadIdx.x / 4; blockDim.x is a
// multiple of 4 and at most kThreads.
__global__ void __launch_bounds__(kThreads)
ed25519_verify_kernel(const uint8_t *__restrict__ p, uint8_t *__restrict__ out,
                      int n, const int32_t *__restrict__ consts) {
    __shared__ int32_t base[kBaseInts];
    __shared__ int32_t cst[30];
    __shared__ int32_t tab[16 * 10 * kThreads];  // [k][limb][thread]
    for (int k = threadIdx.x; k < kBaseInts; k += blockDim.x) base[k] = consts[k];
    for (int k = threadIdx.x; k < 30; k += blockDim.x) cst[k] = consts[kBaseInts + k];
    __syncthreads();

    const int t = threadIdx.x;
    const int r = t & (kGroup - 1);
    const int lane = blockIdx.x * (blockDim.x / kGroup) + t / kGroup;
    const int i = lane < n ? lane : n - 1;  // the ragged tail computes, stores nothing
    Fe D, D2, SQRT_M1;
#pragma unroll
    for (int k = 0; k < 10; k++) {
        D.v[k] = cst[k];
        D2.v[k] = cst[10 + k];
        SQRT_M1.v[k] = cst[20 + k];
    }

    // even threads decode A, odd threads R
    uint64_t w[4];
    load_words(p, n, i, (r & 1) ? 32 : 0, w);
    // the 255-bit y < p = 2^255 − 19
    const bool r_canonical = !((w[3] << 1) == ~1ull && w[2] == ~0ull && w[1] == ~0ull &&
                               w[0] >= 0xffffffffffffffedull);
    Fe x, y;
    const bool ok = decode(w, D, SQRT_M1, x, y) && ((r & 1) == 0 || r_canonical);
    // thread 1 keeps x_R, thread 3 y_R, for the check at the end
    const Fe rc = fe_sel(r & 2, y, x);

    // −A = (−x, y, 1, −x·y) and its niels form, component r:
    // (y − x, y + x, −2d·x·y, 2)
    const Fe xa = fe_shfl4(x, 0), ya = fe_shfl4(y, 0);
    Pt q;
    q.X = fe_neg(xa);
    q.Y = ya;
    q.Z = fe_small(1);
    q.T = fe_neg(fe_mul(xa, ya));
    const Fe na = fe_sel4(r, fe_sub(ya, xa), fe_add(ya, xa), fe_mul(q.T, D2), fe_small(2));

    // the table k·(−A), k = 0..15: this thread's component of each entry
    const Fe ident = fe_small(r == 2 ? 0 : r == 3 ? 2 : 1);
#pragma unroll
    for (int k = 0; k < 10; k++) {
        tab[(0 * 10 + k) * kThreads + t] = ident.v[k];
        tab[(1 * 10 + k) * kThreads + t] = na.v[k];
    }
#pragma unroll 1
    for (int e = 2; e < 16; e++) {
        q = pt_add_niels(r, q, na);
        const Fe c = fe_sel4(r, fe_add(q.Y, q.X), fe_sub(q.Y, q.X), fe_mul(q.T, D2),
                             fe_add(q.Z, q.Z));
#pragma unroll
        for (int k = 0; k < 10; k++) tab[(e * 10 + k) * kThreads + t] = c.v[k];
    }

    // Straus: P = s·B + h·(−A), 4-bit unsigned windows from the top
    uint64_t sw[4], hw[4];
    load_words(p, n, i, 64, sw);
    load_words(p, n, i, 96, hw);
    Pt acc;  // the identity
    acc.X = fe_small(0);
    acc.Y = fe_small(1);
    acc.Z = fe_small(1);
    acc.T = fe_small(0);
#pragma unroll 1
    for (int win = 63; win >= 0; win--) {
        acc = pt_double(r, acc);
        acc = pt_double(r, acc);
        acc = pt_double(r, acc);
        acc = pt_double(r, acc);
        const int sh = (win & 15) * 4;
        const int s_nib = (int)((sw[win >> 4] >> sh) & 15);
        const int h_nib = (int)((hw[win >> 4] >> sh) & 15);
        Fe nb, nh;
#pragma unroll
        for (int k = 0; k < 10; k++) {
            nb.v[k] = base[(s_nib * 4 + r) * 10 + k];
            nh.v[k] = tab[(h_nib * 10 + k) * kThreads + t];
        }
        acc = pt_add_niels(r, acc, nb);
        acc = pt_add_niels(r, acc, nh);
    }

    // R == enc(P): thread 1 checks X_P = x_R·Z_P, thread 3 Y_P = y_R·Z_P
    const bool eq = fe_eq(fe_mul(rc, acc.Z), fe_sel(r & 2, acc.Y, acc.X));
    const int32_t mine = ok && ((r & 1) == 0 || eq);
    const int32_t all = shfl4(mine, 0) & shfl4(mine, 1) & shfl4(mine, 2) & shfl4(mine, 3);
    if (r == 0 && lane < n) out[lane] = (uint8_t)all;
}

}  // namespace

// Launch over n lanes of the packed (128, n) chunk on `stream`: 4 threads
// a lane, kThreads a block.  Returns cudaGetLastError() (0 on success).
// Allocates nothing, does not sync.
extern "C" int ed25519_verify_launch(const void *packed, void *out, int n,
                                     const void *consts, void *stream) {
    if (n <= 0) return 0;
    const long long threads = (long long)kGroup * n;
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
    ed25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (uint8_t *)out, n, (const int32_t *)consts);
    return (int)cudaGetLastError();
}

extern "C" int ed25519_const_ints(void) { return kConstInts; }

extern "C" int ed25519_threads_per_lane(void) { return kGroup; }

extern "C" int ed25519_block_threads(void) { return kThreads; }

extern "C" const char *ed25519_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
