// ed25519_verify.cu — batched cofactorless ed25519 verification on Hopper.
//
// Replaces the TPU kernel stellar_tpu/ops/ed25519_pallas.py::
// verify_kernel_pallas (and computes what its XLA twin
// stellar_tpu/ops/ed25519.py::verify_kernel computes), in two instances of
// one template: unsigned 4-bit windows (signed=False, the default) and the
// signed-digit windows of verify_kernel_pallas(signed=True), which
// STELLAR_TPU_SIGNED_WINDOWS picks; the signed windows have a second
// kernel for narrow launches, the pair (its note below).  The plain
// PyTorch version beside them is stellar_tpu_torch/ops/ed25519.py::
// _verify_packed (its ``signed`` flag); the wrapper is
// stellar_tpu_torch/ops/ed25519_cuda.py.
//
// Input: the packed (128, N) uint8 staging chunk, one lane per column —
// rows 0:32 A, 32:64 R, 64:96 s, 96:128 h = SHA-512(R‖A‖M) mod L, all
// little-endian.  Output: (N,) uint8, 1 iff R == enc(s·B + h·(−A)) and A
// decompressed.  Raw lanes the host gate would reject get the plain
// version's verdict too: y >= p decodes as the 255-bit value mod p, s >= L
// runs unsigned 4-bit windows over all 256 bits (the modular result), an
// undecompressable A fails, and torsion-proof lanes (A := P, s := 0,
// h := L, R := identity encoding) compute [L]·P.  The signed instance
// recodes s and h as the JAX kernel does and drops the carry out of window
// 63 as it does, so a raw scalar >= 0x77…78 (about 2^254.9; every s in
// [8L, 2^256)) is taken as v − 2^256: it rejects such lanes where the
// unsigned instance accepts, as verify_kernel_pallas(signed=True) does.
// No lane that passes the gate (s < L) or carries h mod L, and no torsion
// lane (h = L < 2^253), gets another verdict from the two instances.
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
// The signed instance's algorithm builds the table to k = 8 only: 72M (7
// general adds of 9M, 8 × 2d·T, −A's T), so 1533 squarings and 1895
// multiplications, 3428 field operations; its windows are the same 64 ×
// (16S + 28M) (a select's negation is an addition, not counted).
// As 32-bit integer multiply-adds (IMAD, low and high half each) on a
// 255-bit value held in 8 words: a product is 8×8 word products, 128
// IMADs; a squaring 36 distinct word products, 72 IMADs; the reduction
// folds the 8 high words ×38 into the low 8, 16 IMADs more.  So 144 per
// multiplication and 88 per squaring, 417,864 IMADs per verify; additions
// and carries are not counted, so this stays a lower bound (407,784 for
// the signed instance).  On an H100
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
//   memory.  The signed instance keeps k = 0..8: 64 × 360 B = 22.5 KB plus
//   1.4 KB of the fixed-base table, 24,600 B a block against 43,640;
// - signed digits: s and h are recoded in registers (a 256-bit add of
//   0x88…88, digit = nibble − 8, recode_signed), and a negative digit
//   negates the niels entry at the select with no shuffle: in the
//   [k][limb][thread] layout thread r holds component r, so threads 0 and
//   1 read their partner's slot (t ^ 1 in the table, component r ^ 1 of the
//   fixed-base entry), swapping y+x and y−x, and thread 2 negates its
//   2d·t.  A __syncwarp after the table build orders the partner's writes
//   before those reads;
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
//   2^63; the fixed-base table of k·B comes from the wrapper (built from
//   the port's ref25519) into shared memory.
// Serial chain per lane: ~273 products (decode) + ~45 (table; ~24 for
// the signed instance) + 768 (64 windows × 12) + 1, against 3498 field
// operations in the one-thread design.
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
// 64-bit limbs or tensor cores need fewer).
//
// Residency (64-thread blocks; ptxas -v and ed25519_residency() on an H100
// SXM, printed by chip_smoke.py's build and kernels phases): both
// instances use 168 registers a thread, 0 spills.  The unsigned one's
// 43,640 B of shared memory allow 5 blocks an SM (registers would allow
// 6): shared memory binds.  The signed one's 24,600 B would allow 9, the
// registers 6: registers bind.  At 4096 lanes (256 blocks, about 2 an SM)
// neither limit is reached; at 32768 lanes the 6 blocks against 5 show in
// the time (PERF.md §6).
//
// The pair: the signed windows for narrow launches.  The node launches the
// verify kernel mostly one lane at a time (node_consensus: 1339 of 1374
// launches; scenario_flood: 1488 of 1974), and there the template's signed
// instance (above: the "wide" variant) runs one group of 4 threads through
// the whole chain of one signature: ~1066 product stages (decode 273,
// table 24, 64 windows × 12, check 1), ~0.45 ms on an H100 SXM.  Its bound
// is the signed instance's: 3428 field operations, 407,784 IMADs a verify,
// ≈ 24 ns of the whole card's INT32 rate; a one-lane launch cannot come
// near it, but it can shorten the chain.  The pair is a second kernel of
// the same function (ed25519_cuda.signed_variant picks it up to 2112
// lanes, two pair blocks an SM, one warp a scheduler; the wide variant
// past that): a block of two warps over the same 8 signatures, 4 threads
// a signature in each.
// - The chain warp decodes A, builds the table of k·(−A), k = 0..8, and
//   runs 64 windows of 4 doublings and one niels add of d_h·(−A): 10
//   product stages a window, not 12, with the same recoded digits of h.
// - The comb warp decodes R (with y < p) and sums S = s·B = Σ d_i·16^i·B
//   over the signed comb from the wrapper (k·16^i·B for i = 0..63, k =
//   1..8, affine niels (y+x, y−x, 2d·xy): 61,440 B, read through __ldg and
//   held in L2 and L1; the next window's entry is loaded while the current
//   addition runs): 64 additions and no doubling, with the same recoded
//   digits of s, so the carry out of window 63 is dropped as the wide
//   variant drops it.  A negative digit negates the entry at the select,
//   as in the wide variant; a zero digit selects the identity.
// - One __syncthreads joins them: the comb warp hands S in niels form (Y+X,
//   Y−X, 2d·T, 2Z), x_R, y_R and R's verdict over shared memory; the chain
//   warp forms P = H + S (one niels add) and checks R as the wide variant
//   does, with the same verdict form.
// - The chain's additions stay lazy (lz_add, lz_sub, pt_double_lazy,
//   pt_add_niels_lazy): only the operand a product multiplies by 19 is
//   carried, ~24 % fewer instructions a window.
// Chain: ~939 stages (decode 273, table 23, windows 640, join 3) against
// the wide variant's ~1066; the comb warp's ~402 (decode 273, 128 adds, 1)
// run on another scheduler, off the chain.  Block 0's clock64 stamps
// (kernel_ab.py, -DED25519_PAIR_STAMPS; PERF.md §6) time each phase.
// Past 2112 lanes two chain warps share a scheduler and the pair loses to
// the wide variant, which keeps twice the signatures resident (the pair:
// 164 registers, 14,328 B of shared memory, 6 blocks an SM, registers
// bind: 48 signatures an SM against 96).


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

// Signed-digit recode of a 256-bit scalar in place: digit t becomes nibble
// t − 8 of w + 0x88…88, in [−8, 7].  The nibble of the sum is n_t + 8 + c_t
// mod 16 with the carry c_{t+1} = (n_t + c_t >= 8), which is the JAX
// kernel's loop d = n_t + c_t, c_{t+1} = d >= 8, d −= 16·c_{t+1}
// (ed25519_pallas.py:138-145) in closed form; the carry out of bit 255 is
// dropped, as there.
__device__ __forceinline__ void recode_signed(uint64_t w[4]) {
    const uint64_t k8 = 0x8888888888888888ull;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const uint64_t a = w[k] + k8;
        const uint64_t b = a + c;
        c = (uint64_t)(a < k8) | (uint64_t)(b < a);
        w[k] = b;
    }
}

// Lane i = blockIdx.x · (blockDim.x / 4) + threadIdx.x / 4; blockDim.x is a
// multiple of 4 and at most kThreads.  kSigned: the signed-digit windows of
// verify_kernel_pallas(signed=True), tables of k = 0..8 (module note).
template <bool kSigned = false>
__global__ void __launch_bounds__(kThreads)
ed25519_verify_kernel(const uint8_t *__restrict__ p, uint8_t *__restrict__ out,
                      int n, const int32_t *__restrict__ consts) {
    constexpr int kTab = kSigned ? 9 : 16;  // table entries k = 0..kTab−1
    __shared__ int32_t base[kTab * 4 * 10];
    __shared__ int32_t cst[30];
    __shared__ int32_t tab[kTab * 10 * kThreads];  // [k][limb][thread]
    for (int k = threadIdx.x; k < kTab * 4 * 10; k += blockDim.x) base[k] = consts[k];
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

    // the table k·(−A), k = 0..kTab−1: this thread's component of each entry
    const Fe ident = fe_small(r == 2 ? 0 : r == 3 ? 2 : 1);
#pragma unroll
    for (int k = 0; k < 10; k++) {
        tab[(0 * 10 + k) * kThreads + t] = ident.v[k];
        tab[(1 * 10 + k) * kThreads + t] = na.v[k];
    }
#pragma unroll 1
    for (int e = 2; e < kTab; e++) {
        q = pt_add_niels(r, q, na);
        const Fe c = fe_sel4(r, fe_add(q.Y, q.X), fe_sub(q.Y, q.X), fe_mul(q.T, D2),
                             fe_add(q.Z, q.Z));
#pragma unroll
        for (int k = 0; k < 10; k++) tab[(e * 10 + k) * kThreads + t] = c.v[k];
    }
    // a negative digit makes threads 0 and 1 read each other's slots
    if constexpr (kSigned) __syncwarp();

    // Straus: P = s·B + h·(−A), 4-bit windows from the top (unsigned
    // nibbles, or signed digits recoded in place)
    uint64_t sw[4], hw[4];
    load_words(p, n, i, 64, sw);
    load_words(p, n, i, 96, hw);
    if constexpr (kSigned) {
        recode_signed(sw);
        recode_signed(hw);
    }
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
        if constexpr (kSigned) {
            // digit d = nibble − 8: entry |d|, negated for d < 0 — y+x and
            // y−x trade places (threads 0 and 1 read the partner's
            // component) and thread 2 negates its 2d·t
            const int s_d = s_nib - 8, h_d = h_nib - 8;
            const bool s_neg = s_d < 0, h_neg = h_d < 0;
            const int s_k = s_neg ? -s_d : s_d, h_k = h_neg ? -h_d : h_d;
            const int rs = (s_neg && r < 2) ? r ^ 1 : r;
            const int th = (h_neg && r < 2) ? t ^ 1 : t;
#pragma unroll
            for (int k = 0; k < 10; k++) {
                nb.v[k] = base[(s_k * 4 + rs) * 10 + k];
                nh.v[k] = tab[(h_k * 10 + k) * kThreads + th];
            }
            nb = fe_sel(s_neg && r == 2, fe_neg(nb), nb);
            nh = fe_sel(h_neg && r == 2, fe_neg(nh), nh);
        } else {
#pragma unroll
            for (int k = 0; k < 10; k++) {
                nb.v[k] = base[(s_nib * 4 + r) * 10 + k];
                nh.v[k] = tab[(h_nib * 10 + k) * kThreads + t];
            }
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

// --- the pair: B1s for narrow launches ------------------------------------

// Lazy arithmetic of the pair (module note): limbwise, no carry.  Every
// limb stays non-negative: a − b adds 2p (b carried) or 4p (b a lazy sum
// of two carried values), whose limbs exceed b's.  A lazy value enters a
// product only as its first operand, whose limbs fe_mul doubles at most
// (the second is multiplied by 19 and must be carried).
__device__ __forceinline__ Fe lz_add(const Fe &a, const Fe &b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + b.v[i];
    return r;
}

__device__ __forceinline__ Fe lz_sub(const Fe &a, const Fe &b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + ((i == 0) ? (1 << 27) - 38 : (2 << BITS(i)) - 2) - b.v[i];
    return r;
}

__device__ __forceinline__ Fe lz_sub4(const Fe &a, const Fe &b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + ((i == 0) ? (1 << 28) - 76 : (4 << BITS(i)) - 4) - b.v[i];
    return r;
}

__device__ __forceinline__ Fe fe_carry(const Fe &a) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = a.v[i];
    return carry(h);
}

// pt_double with the second stage's operands lazy: thread r forms E, F, G
// and H without a carry, carries only the operand its product multiplies
// by 19.  Limbs of the first operand stay below 1.75·2^28 (2^27 odd), so a
// product column stays below 2^62.
__device__ __forceinline__ Pt pt_double_lazy(int r, const Pt &p) {
    const Pt q = gather(fe_sq(fe_sel4(r, p.X, p.Y, p.Z, fe_add(p.X, p.Y))));
    const Fe ab = lz_add(q.X, q.Y);
    const Fe g = lz_sub(q.Y, q.X);
    const Fe e = lz_sub4(q.T, ab), h = lz_sub4(fe_small(0), ab);
    const Fe f = lz_sub4(g, lz_add(q.Z, q.Z));
    return gather(fe_mul(fe_sel4(r, e, g, f, e), fe_carry(fe_sel4(r, f, h, g, h))));
}

// pt_add_niels with lazy operands: Y+X and Y−X uncarried into the first
// stage (n_r, carried, is the product's second operand), E, F, G, H
// uncarried into the second.
__device__ __forceinline__ Pt pt_add_niels_lazy(int r, const Pt &p, const Fe &n_r) {
    const Pt q = gather(fe_mul(fe_sel4(r, lz_add(p.Y, p.X), lz_sub(p.Y, p.X), p.T, p.Z), n_r));
    const Fe e = lz_sub(q.X, q.Y), f = lz_sub(q.T, q.Z), g = lz_add(q.T, q.Z), h = lz_add(q.X, q.Y);
    return gather(fe_mul(fe_sel4(r, e, g, f, e), fe_carry(fe_sel4(r, f, h, g, h))));
}

// the signed comb from the wrapper: k·16^i·B for i = 0..63, k = 1..8, in
// affine niels form (y+x, y−x, 2d·x·y), as [i][k−1][component][limb]
constexpr int kCombInts = 64 * 8 * 3 * 10;
constexpr int kPairSigs = 32 / kGroup;  // signatures a pair block: 8

// This thread's component of the comb entry d·16^win·B, d in [−8, 7]: the
// identity (1, 1, 0) for d = 0, entry |d| negated for d < 0 (threads 0 and
// 1 read the partner component, thread 2 negates 2d·xy); thread 3's
// component is the constant 2z = 2.
__device__ __forceinline__ Fe comb_entry(const int32_t *__restrict__ comb, int win, int d,
                                         int r) {
    const bool neg = d < 0;
    const int k = neg ? -d : d;
    const int c = (neg && r < 2) ? r ^ 1 : (r < 3 ? r : 2);
    const int32_t *e = comb + ((win * 8 + (k > 0 ? k - 1 : 0)) * 3 + c) * 10;
    Fe v;
#pragma unroll
    for (int l = 0; l < 10; l++) v.v[l] = __ldg(e + l);
    const Fe fixed = fe_small(r == 2 ? 0 : r == 3 ? 2 : 1);
    v = fe_sel(k == 0 || r == 3, fixed, v);
    return fe_sel(neg && r == 2 && k > 0, fe_neg(v), v);
}

// Signed digit win of a recoded scalar (recode_signed), in [−8, 7].
__device__ __forceinline__ int digit_signed(const uint64_t w[4], int win) {
    return (int)((w[win >> 4] >> ((win & 15) * 4)) & 15) - 8;
}

// Cycle stamps of block 0's two warps ([0] the chain warp, [1] the comb
// warp) at the pair's phase boundaries (PAIR_STAMPS in kernel_ab.py), and
// the global timer (ns) at the chain warp's first and last stamp, read by
// kernel_ab.py from a build with -DED25519_PAIR_STAMPS; nothing otherwise.
constexpr int kPairStamps = 8;
#ifdef ED25519_PAIR_STAMPS
__device__ long long g_pair_stamps[2][kPairStamps];
__device__ unsigned long long g_pair_ns[2];
__device__ __forceinline__ void pair_stamp(int k) {
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) {
        g_pair_stamps[threadIdx.x >> 5][k] = clock64();
        if (threadIdx.x == 0 && (k == 0 || k == kPairStamps - 1)) {
            unsigned long long t;
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
            g_pair_ns[k ? 1 : 0] = t;
        }
    }
}
#else
__device__ __forceinline__ void pair_stamp(int) {}
#endif

// The pair (module note): a block is two warps over the same kPairSigs
// signatures, 4 threads a signature in each.  Warp 0, the chain warp:
// decodes A, builds the table of k·(−A), k = 0..8, runs 64 windows of 4
// doublings and one niels add of d_h·(−A) (10 product stages, not 12).
// Warp 1, the comb warp: decodes R (with y < p), sums S = s·B over the
// comb (64 niels adds, no doubling) and hands S in niels form, x_R, y_R and
// R's verdict over shared memory; after one __syncthreads the chain warp
// adds S and checks R as the wide variant does.
__global__ void __launch_bounds__(kThreads)
ed25519_verify_signed_pair_kernel(const uint8_t *__restrict__ p, uint8_t *__restrict__ out,
                                  int n, const int32_t *__restrict__ consts,
                                  const int32_t *__restrict__ comb) {
    pair_stamp(0);
    constexpr int kTab = 9;
    __shared__ int32_t cst[30];
    __shared__ int32_t tab[kTab * 10 * 32];  // the chain warp's [k][limb][thread]
    __shared__ int32_t s_niels[10 * 32];     // S, component r: [limb][thread]
    __shared__ int32_t r_coord[10 * 32];     // x_R (r = 0, 1) or y_R (r = 2, 3)
    __shared__ int32_t r_ok[32];
    for (int k = threadIdx.x; k < 30; k += blockDim.x) cst[k] = consts[kBaseInts + k];
    __syncthreads();
    pair_stamp(1);

    const bool chain = threadIdx.x < 32;
    const int t = threadIdx.x & 31;
    const int r = t & (kGroup - 1);
    const int lane = blockIdx.x * kPairSigs + t / kGroup;
    const int i = lane < n ? lane : n - 1;  // the ragged tail computes, stores nothing
    Fe D, D2, SQRT_M1;
#pragma unroll
    for (int k = 0; k < 10; k++) {
        D.v[k] = cst[k];
        D2.v[k] = cst[10 + k];
        SQRT_M1.v[k] = cst[20 + k];
    }

    Pt acc;  // the identity
    acc.X = fe_small(0);
    acc.Y = fe_small(1);
    acc.Z = fe_small(1);
    acc.T = fe_small(0);
    bool ok_a = false;
    uint64_t w[4];
    if (chain) {
        load_words(p, n, i, 0, w);
        Fe x, y;
        ok_a = decode(w, D, SQRT_M1, x, y);
        pair_stamp(2);
        // −A = (−x, y, 1, −x·y), niels component r: (y − x, y + x, −2d·x·y, 2)
        Pt q;
        q.X = fe_neg(x);
        q.Y = y;
        q.Z = fe_small(1);
        q.T = fe_neg(fe_mul(x, y));
        const Fe na = fe_sel4(r, fe_sub(y, x), fe_add(y, x), fe_mul(q.T, D2), fe_small(2));
        const Fe ident = fe_small(r == 2 ? 0 : r == 3 ? 2 : 1);
#pragma unroll
        for (int k = 0; k < 10; k++) {
            tab[(0 * 10 + k) * 32 + t] = ident.v[k];
            tab[(1 * 10 + k) * 32 + t] = na.v[k];
        }
#pragma unroll 1
        for (int e = 2; e < kTab; e++) {
            q = pt_add_niels_lazy(r, q, na);
            const Fe c = fe_sel4(r, fe_add(q.Y, q.X), fe_sub(q.Y, q.X), fe_mul(q.T, D2),
                                 fe_add(q.Z, q.Z));
#pragma unroll
            for (int k = 0; k < 10; k++) tab[(e * 10 + k) * 32 + t] = c.v[k];
        }
        // a negative digit makes threads 0 and 1 read each other's slots
        __syncwarp();
        pair_stamp(3);
        load_words(p, n, i, 96, w);
        recode_signed(w);
#pragma unroll 1
        for (int win = 63; win >= 0; win--) {
            acc = pt_double_lazy(r, acc);
            acc = pt_double_lazy(r, acc);
            acc = pt_double_lazy(r, acc);
            acc = pt_double_lazy(r, acc);
            const int d = digit_signed(w, win);
            const bool neg = d < 0;
            const int k = neg ? -d : d;
            const int th = (neg && r < 2) ? t ^ 1 : t;
            Fe nh;
#pragma unroll
            for (int l = 0; l < 10; l++) nh.v[l] = tab[(k * 10 + l) * 32 + th];
            nh = fe_sel(neg && r == 2, fe_neg(nh), nh);
            acc = pt_add_niels_lazy(r, acc, nh);
        }
        pair_stamp(4);
    } else {
        load_words(p, n, i, 32, w);
        // the 255-bit y < p = 2^255 − 19
        const bool r_canonical = !((w[3] << 1) == ~1ull && w[2] == ~0ull && w[1] == ~0ull &&
                                   w[0] >= 0xffffffffffffffedull);
        Fe x, y;
        const bool ok_r = decode(w, D, SQRT_M1, x, y) && r_canonical;
        pair_stamp(2);
        load_words(p, n, i, 64, w);
        recode_signed(w);
        // S = Σ d_i·16^i·B; the next window's entry is loaded before the
        // current addition runs
        Fe cur = comb_entry(comb, 0, digit_signed(w, 0), r);
#pragma unroll 1
        for (int win = 0; win < 64; win++) {
            const int nx = win < 63 ? win + 1 : 63;
            const Fe next = comb_entry(comb, nx, digit_signed(w, nx), r);
            acc = pt_add_niels_lazy(r, acc, cur);
            cur = next;
        }
        pair_stamp(4);
        // S in niels form, component r: (Y+X, Y−X, 2d·T, 2Z)
        const Fe c = fe_sel4(r, fe_add(acc.Y, acc.X), fe_sub(acc.Y, acc.X), fe_mul(acc.T, D2),
                             fe_add(acc.Z, acc.Z));
        const Fe rc = fe_sel(r & 2, y, x);
#pragma unroll
        for (int k = 0; k < 10; k++) {
            s_niels[k * 32 + t] = c.v[k];
            r_coord[k * 32 + t] = rc.v[k];
        }
        r_ok[t] = ok_r;
        pair_stamp(5);
    }
    __syncthreads();
    pair_stamp(6);
    if (!chain) return;

    // P = H + S; R == enc(P): thread 1 checks X_P = x_R·Z_P, thread 3
    // Y_P = y_R·Z_P
    Fe ns, rc;
#pragma unroll
    for (int k = 0; k < 10; k++) {
        ns.v[k] = s_niels[k * 32 + t];
        rc.v[k] = r_coord[k * 32 + t];
    }
    acc = pt_add_niels_lazy(r, acc, ns);
    const bool eq = fe_eq(fe_mul(rc, acc.Z), fe_sel(r & 2, acc.Y, acc.X));
    const int32_t mine = ok_a && r_ok[t] && ((r & 1) == 0 || eq);
    const int32_t all = shfl4(mine, 0) & shfl4(mine, 1) & shfl4(mine, 2) & shfl4(mine, 3);
    if (r == 0 && lane < n) out[lane] = (uint8_t)all;
    pair_stamp(kPairStamps - 1);
}

}  // namespace

template <bool kSigned>
static int launch(const void *packed, void *out, int n, const void *consts, void *stream) {
    if (n <= 0) return 0;
    const long long threads = (long long)kGroup * n;
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
    ed25519_verify_kernel<kSigned><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (uint8_t *)out, n, (const int32_t *)consts);
    return (int)cudaGetLastError();
}

// Launch over n lanes of the packed (128, n) chunk on `stream`: 4 threads
// a lane, kThreads a block.  Returns cudaGetLastError() (0 on success).
// Allocates nothing, does not sync.
extern "C" int ed25519_verify_launch(const void *packed, void *out, int n,
                                     const void *consts, void *stream) {
    return launch<false>(packed, out, n, consts, stream);
}

// The same over the signed-digit instance (STELLAR_TPU_SIGNED_WINDOWS).
extern "C" int ed25519_verify_signed_launch(const void *packed, void *out, int n,
                                            const void *consts, void *stream) {
    return launch<true>(packed, out, n, consts, stream);
}

// The signed-digit windows over the pair (two warps a block of kPairSigs
// signatures); `comb` is the wrapper's kCombInts-int signed comb.
extern "C" int ed25519_verify_signed_pair_launch(const void *packed, void *out, int n,
                                                 const void *consts, const void *comb,
                                                 void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kPairSigs - 1) / kPairSigs;
    ed25519_verify_signed_pair_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (uint8_t *)out, n, (const int32_t *)consts,
        (const int32_t *)comb);
    return (int)cudaGetLastError();
}

// Residency of one kernel on the current device, from the runtime (kernel
// 0 the unsigned instance, 1 the signed one, 2 the pair): info =
// {registers a thread, static shared bytes a block, local bytes a thread,
// resident blocks an SM (the occupancy calculator), blocks an SM that
// shared memory alone allows, blocks an SM that registers alone allow}.
// Returns the first CUDA error, 0 on success.
extern "C" int ed25519_residency(int kernel, int *info) {
    const void *fn = kernel == 2   ? (const void *)ed25519_verify_signed_pair_kernel
                     : kernel == 1 ? (const void *)ed25519_verify_kernel<true>
                                   : (const void *)ed25519_verify_kernel<false>;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    int dev = 0, blocks = 0, smem_sm = 0, regs_sm = 0, reserved = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&regs_sm, cudaDevAttrMaxRegistersPerMultiprocessor, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err != cudaSuccess) return (int)err;
    // registers are allocated a warp at a time, in units of 256
    const int warp_regs = (a.numRegs * 32 + 255) / 256 * 256;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)a.localSizeBytes;
    info[3] = blocks;
    info[4] = smem_sm / ((int)a.sharedSizeBytes + reserved);
    info[5] = regs_sm / (warp_regs * (kThreads / 32));
    return 0;
}

#ifdef ED25519_PAIR_STAMPS
// Copy block 0's stamps of the last pair launch to `host` ([2][kPairStamps]
// cycles, then the two ns readings) and clear them; synchronises the device.
extern "C" int ed25519_pair_stamps(long long *host) {
    static const long long zero[2][kPairStamps] = {};
    cudaDeviceSynchronize();
    cudaMemcpyFromSymbol(host, g_pair_stamps, sizeof(g_pair_stamps));
    cudaMemcpyFromSymbol(host + 2 * kPairStamps, g_pair_ns, sizeof(g_pair_ns));
    cudaMemcpyToSymbol(g_pair_stamps, zero, sizeof(g_pair_stamps));
    return (int)cudaGetLastError();
}
#endif

extern "C" int ed25519_const_ints(void) { return kConstInts; }

extern "C" int ed25519_comb_ints(void) { return kCombInts; }

extern "C" int ed25519_threads_per_lane(void) { return kGroup; }

extern "C" int ed25519_block_threads(void) { return kThreads; }

extern "C" const char *ed25519_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
