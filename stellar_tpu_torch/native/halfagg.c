/* halfagg — CPython extension: the ed25519 half-aggregation curve core.
 *
 * The aggregate-signature consensus plane (stellar_tpu/crypto/aggregate/)
 * verifies a whole slot's SCP ballot envelopes with ONE multi-scalar
 * multiplication:
 *
 *     s̄·B  ==  Σ z_i·R_i  +  Σ (z_i·h_i mod L)·A_i
 *
 * instead of n independent libsodium verifies.  The scalar side (h_i,
 * z_i, s̄ = Σ z_i·s_i mod L) is cheap and stays in Python (hashlib +
 * bigints); the POINT side is this module:
 *
 *   - ``decompress``: strict batch point decoding (canonical y < p,
 *     on-curve, no x=0-with-sign alias) into raw 5×51-limb extended
 *     coordinates — per-item ok flags, so one hostile encoding marks one
 *     item invalid instead of aborting the batch.  The limb blobs are
 *     host-local cache currency: the aggregate plane memoizes decoded
 *     validator keys (the A_i are stable across slots) and only fresh
 *     R_i pay the square-root exponentiation.
 *   - ``msm_ext`` / ``msm``: Pippenger/bucket multi-scalar multiplication
 *     (8-bit windows, 255 buckets, running-sum reduction) over the
 *     complete twisted-Edwards addition law — ~60k point additions for a
 *     2000-point slot vs ~500k point operations for 1000 independent
 *     verifies.  Scalars arrive already reduced mod L (32-byte LE).
 *   - ``torsion_free``: batch prime-order-subgroup proof, [L]·P ==
 *     identity per point.  The cofactorless MSM check alone has only
 *     1/8 soundness against mixed-torsion inputs (a defect that is pure
 *     8-torsion survives whenever the Fiat-Shamir z_i conspire mod 8 —
 *     the exact failure a plain batch random-linear-combination check has),
 *     so the aggregate plane only trusts an MSM pass over points proven
 *     prime-order.  The proof costs ~one scalar multiplication per
 *     point — amortized to zero for validator keys (PointCache), paid
 *     once per fresh R.
 *
 * Field arithmetic is 5×51-bit limbs with __uint128_t accumulation
 * (curve25519-donna shape), written from RFC 7748/8032 and the curve
 * equations like ops/ref25519.py — which is also the differential oracle:
 * tests/test_halfagg.py pins decompress/msm bit-exact against the pure-
 * Python implementation on random, structured, and hostile inputs.  The
 * a=-1 twisted-Edwards addition law used here is COMPLETE on this curve
 * (-1 is a QR mod 2^255-19, d is not a QR), so identity/duplicate/mixed-
 * torsion operands need no special cases.
 *
 * NOT constant-time, deliberately: every input is public (signatures,
 * public keys, Fiat-Shamir coefficients) — this is a verifier, never a
 * signer.  The GIL is released for the whole batch compute.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef uint64_t fe[5];
typedef __uint128_t u128;

#define M51 0x7ffffffffffffULL

static const fe fe_d = {0x34dca135978a3ULL, 0x1a8283b156ebdULL,
                        0x5e7a26001c029ULL, 0x739c663a03cbbULL,
                        0x52036cee2b6ffULL};
static const fe fe_d2 = {0x69b9426b2f159ULL, 0x35050762add7aULL,
                         0x3cf44c0038052ULL, 0x6738cc7407977ULL,
                         0x2406d9dc56dffULL};
static const fe fe_sqrtm1 = {0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL,
                             0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL,
                             0x2b8324804fc1dULL};
/* p-2, little-endian: generic square-and-multiply exponent for the
 * compress inversion (once per MSM; the per-point decompress square
 * root uses the fe_pow22523 addition chain instead) */
static const uint8_t EXP_PM2[32] = {
    0xeb, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};

/* ------------------------------------------------------------------ */
/* field element arithmetic (mod 2^255-19), 5x51-bit limbs            */
/* ------------------------------------------------------------------ */

static void fe_0(fe h) { memset(h, 0, sizeof(fe)); }
static void fe_1(fe h) { fe_0(h); h[0] = 1; }
static void fe_copy(fe h, const fe f) { memcpy(h, f, sizeof(fe)); }

/* weak reduction: limbs back under 2^52 (inputs below ~2^63) */
static void fe_carry(fe h)
{
    uint64_t c;
    c = h[0] >> 51; h[0] &= M51; h[1] += c;
    c = h[1] >> 51; h[1] &= M51; h[2] += c;
    c = h[2] >> 51; h[2] &= M51; h[3] += c;
    c = h[3] >> 51; h[3] &= M51; h[4] += c;
    c = h[4] >> 51; h[4] &= M51; h[0] += 19 * c;
    c = h[0] >> 51; h[0] &= M51; h[1] += c;
}

/* h = f + g; inputs < 2^52, output < 2^53 (callers feed fe_mul, which
 * tolerates 2^54, or fe_carry first) */
static void fe_add(fe h, const fe f, const fe g)
{
    for (int i = 0; i < 5; i++)
        h[i] = f[i] + g[i];
}

/* h = f - g (mod p) via f + 2p - g; f < 2^53, g < 2^52; output < 2^54 */
static void fe_sub(fe h, const fe f, const fe g)
{
    h[0] = f[0] + 0xfffffffffffdaULL - g[0];
    h[1] = f[1] + 0xffffffffffffeULL - g[1];
    h[2] = f[2] + 0xffffffffffffeULL - g[2];
    h[3] = f[3] + 0xffffffffffffeULL - g[3];
    h[4] = f[4] + 0xffffffffffffeULL - g[4];
}

/* h = f * g; inputs < 2^54, output < 2^52 */
static void fe_mul(fe h, const fe f, const fe g)
{
    u128 t0, t1, t2, t3, t4;
    uint64_t g1_19 = 19 * g[1], g2_19 = 19 * g[2], g3_19 = 19 * g[3],
             g4_19 = 19 * g[4];

    t0 = (u128)f[0] * g[0] + (u128)f[1] * g4_19 + (u128)f[2] * g3_19 +
         (u128)f[3] * g2_19 + (u128)f[4] * g1_19;
    t1 = (u128)f[0] * g[1] + (u128)f[1] * g[0] + (u128)f[2] * g4_19 +
         (u128)f[3] * g3_19 + (u128)f[4] * g2_19;
    t2 = (u128)f[0] * g[2] + (u128)f[1] * g[1] + (u128)f[2] * g[0] +
         (u128)f[3] * g4_19 + (u128)f[4] * g3_19;
    t3 = (u128)f[0] * g[3] + (u128)f[1] * g[2] + (u128)f[2] * g[1] +
         (u128)f[3] * g[0] + (u128)f[4] * g4_19;
    t4 = (u128)f[0] * g[4] + (u128)f[1] * g[3] + (u128)f[2] * g[2] +
         (u128)f[3] * g[1] + (u128)f[4] * g[0];

    uint64_t r0, r1, r2, r3, r4, c;
    r0 = (uint64_t)t0 & M51; t1 += (uint64_t)(t0 >> 51);
    r1 = (uint64_t)t1 & M51; t2 += (uint64_t)(t1 >> 51);
    r2 = (uint64_t)t2 & M51; t3 += (uint64_t)(t2 >> 51);
    r3 = (uint64_t)t3 & M51; t4 += (uint64_t)(t3 >> 51);
    r4 = (uint64_t)t4 & M51;
    r0 += 19 * (uint64_t)(t4 >> 51);
    c = r0 >> 51; r0 &= M51; r1 += c;
    h[0] = r0; h[1] = r1; h[2] = r2; h[3] = r3; h[4] = r4;
}

/* h = f^2; inputs < 2^54, output < 2^52 — the doubled-cross-term
 * squaring (15 limb products vs fe_mul's 25); pow22523/fe_pow and the
 * doubling ladder are squaring-dominated, so this is ~30% of their cost */
static void fe_sq(fe h, const fe f)
{
    u128 t0, t1, t2, t3, t4;
    uint64_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
    uint64_t f0_2 = f0 * 2, f1_2 = f1 * 2;
    uint64_t f1_38 = 38 * f1, f2_38 = 38 * f2, f3_38 = 38 * f3,
             f3_19 = 19 * f3, f4_19 = 19 * f4;

    t0 = (u128)f0 * f0 + (u128)f1_38 * f4 + (u128)f2_38 * f3;
    t1 = (u128)f0_2 * f1 + (u128)f2_38 * f4 + (u128)f3_19 * f3;
    t2 = (u128)f0_2 * f2 + (u128)f1 * f1 + (u128)f3_38 * f4;
    t3 = (u128)f0_2 * f3 + (u128)f1_2 * f2 + (u128)f4_19 * f4;
    t4 = (u128)f0_2 * f4 + (u128)f1_2 * f3 + (u128)f2 * f2;

    uint64_t r0, r1, r2, r3, r4, c;
    r0 = (uint64_t)t0 & M51; t1 += (uint64_t)(t0 >> 51);
    r1 = (uint64_t)t1 & M51; t2 += (uint64_t)(t1 >> 51);
    r2 = (uint64_t)t2 & M51; t3 += (uint64_t)(t2 >> 51);
    r3 = (uint64_t)t3 & M51; t4 += (uint64_t)(t3 >> 51);
    r4 = (uint64_t)t4 & M51;
    r0 += 19 * (uint64_t)(t4 >> 51);
    c = r0 >> 51; r0 &= M51; r1 += c;
    h[0] = r0; h[1] = r1; h[2] = r2; h[3] = r3; h[4] = r4;
}

/* generic square-and-multiply; exponent public (verifier-only module) */
static void fe_pow(fe out, const fe base, const uint8_t exp[32])
{
    fe acc, b;
    fe_1(acc);
    fe_copy(b, base);
    for (int bit = 254; bit >= 0; bit--) {
        fe_sq(acc, acc);
        if ((exp[bit >> 3] >> (bit & 7)) & 1)
            fe_mul(acc, acc, b);
    }
    fe_copy(out, acc);
}

static void fe_sqn(fe h, const fe f, int n)
{
    fe_sq(h, f);
    for (int i = 1; i < n; i++)
        fe_sq(h, h);
}

/* z^(2^252-3) — the decompress square-root exponent — via the ref10
 * addition chain (~254 squarings + 12 multiplies vs ~503 ops for the
 * generic ladder; decompress is the per-point cost the flood pays) */
static void fe_pow22523(fe out, const fe z)
{
    fe t0, t1, t2;
    fe_sq(t0, z);                    /* z^2 */
    fe_sqn(t1, t0, 2);               /* z^8 */
    fe_mul(t1, z, t1);               /* z^9 */
    fe_mul(t0, t0, t1);              /* z^11 */
    fe_sq(t0, t0);                   /* z^22 */
    fe_mul(t0, t1, t0);              /* z^31 = z^(2^5-1) */
    fe_sqn(t1, t0, 5);
    fe_mul(t0, t1, t0);              /* z^(2^10-1) */
    fe_sqn(t1, t0, 10);
    fe_mul(t1, t1, t0);              /* z^(2^20-1) */
    fe_sqn(t2, t1, 20);
    fe_mul(t1, t2, t1);              /* z^(2^40-1) */
    fe_sqn(t1, t1, 10);
    fe_mul(t0, t1, t0);              /* z^(2^50-1) */
    fe_sqn(t1, t0, 50);
    fe_mul(t1, t1, t0);              /* z^(2^100-1) */
    fe_sqn(t2, t1, 100);
    fe_mul(t1, t2, t1);              /* z^(2^200-1) */
    fe_sqn(t1, t1, 50);
    fe_mul(t0, t1, t0);              /* z^(2^250-1) */
    fe_sqn(t0, t0, 2);               /* z^(2^252-4) */
    fe_mul(out, t0, z);              /* z^(2^252-3) */
}

/* canonical 255-bit little-endian encoding (bit 255 clear) */
static void fe_tobytes(uint8_t *s, const fe f)
{
    fe t;
    fe_copy(t, f);
    fe_carry(t);
    fe_carry(t);
    /* t < 2p: conditionally subtract p */
    uint64_t q = (t[0] + 19) >> 51;
    q = (t[1] + q) >> 51;
    q = (t[2] + q) >> 51;
    q = (t[3] + q) >> 51;
    q = (t[4] + q) >> 51;
    t[0] += 19 * q;
    uint64_t c;
    c = t[0] >> 51; t[0] &= M51; t[1] += c;
    c = t[1] >> 51; t[1] &= M51; t[2] += c;
    c = t[2] >> 51; t[2] &= M51; t[3] += c;
    c = t[3] >> 51; t[3] &= M51; t[4] += c;
    t[4] &= M51;
    uint64_t lo0 = t[0] | (t[1] << 51);
    uint64_t lo1 = (t[1] >> 13) | (t[2] << 38);
    uint64_t lo2 = (t[2] >> 26) | (t[3] << 25);
    uint64_t lo3 = (t[3] >> 39) | (t[4] << 12);
    memcpy(s, &lo0, 8);
    memcpy(s + 8, &lo1, 8);
    memcpy(s + 16, &lo2, 8);
    memcpy(s + 24, &lo3, 8);
}

static uint64_t load8(const uint8_t *s)
{
    uint64_t v;
    memcpy(&v, s, 8);
    return v;
}

/* load 255 bits (bit 255 ignored) */
static void fe_frombytes(fe h, const uint8_t *s)
{
    h[0] = load8(s) & M51;
    h[1] = (load8(s + 6) >> 3) & M51;
    h[2] = (load8(s + 12) >> 6) & M51;
    h[3] = (load8(s + 19) >> 1) & M51;
    h[4] = (load8(s + 24) >> 12) & M51;
}

static int fe_iszero(const fe f)
{
    uint8_t s[32];
    fe_tobytes(s, f);
    uint8_t acc = 0;
    for (int i = 0; i < 32; i++)
        acc |= s[i];
    return acc == 0;
}

static int fe_eq(const fe f, const fe g)
{
    fe d;
    fe_sub(d, f, g);
    return fe_iszero(d);
}

/* is the 255-bit value (sign bit masked) canonical, i.e. < p? */
static int bytes_canonical(const uint8_t *s)
{
    /* non-canonical iff low 255 bits >= p = 2^255-19, i.e. bytes
     * 1..30 all 0xff, byte 31 (masked) 0x7f, byte 0 >= 0xed */
    if ((s[31] & 0x7f) != 0x7f)
        return 1;
    for (int i = 1; i < 31; i++)
        if (s[i] != 0xff)
            return 1;
    return s[0] < 0xed;
}

/* ------------------------------------------------------------------ */
/* group elements: extended homogeneous (X, Y, Z, T), x=X/Z, y=Y/Z,    */
/* T = XY/Z — the exact coordinate system of ops/ref25519.py           */
/* ------------------------------------------------------------------ */

typedef struct {
    fe X, Y, Z, T;
} ge;

static void ge_ident(ge *p)
{
    fe_0(p->X);
    fe_1(p->Y);
    fe_1(p->Z);
    fe_0(p->T);
}

/* complete unified addition (add-2008-hwcd-3, a=-1):
 * A=(Y1-X1)(Y2-X2)  B=(Y1+X1)(Y2+X2)  C=2d*T1*T2  D=2*Z1*Z2
 * E=B-A F=D-C G=D+C H=B+A ; X3=EF Y3=GH Z3=FG T3=EH */
static void ge_add(ge *r, const ge *p, const ge *q)
{
    fe a, b, c, d, e, f, g, h, t;

    fe_sub(t, p->Y, p->X);
    fe_carry(t);
    fe_sub(a, q->Y, q->X);
    fe_carry(a);
    fe_mul(a, t, a);
    fe_add(t, p->Y, p->X);
    fe_add(b, q->Y, q->X);
    fe_mul(b, t, b);
    fe_mul(c, p->T, q->T);
    fe_mul(c, c, fe_d2);
    fe_mul(d, p->Z, q->Z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_carry(f);
    fe_add(g, d, c);
    fe_carry(g);
    fe_add(h, b, a);
    fe_mul(r->X, e, f);
    fe_mul(r->Y, g, h);
    fe_mul(r->Z, f, g);
    fe_mul(r->T, e, h);
}

/* dedicated doubling (dbl-2008-hwcd, a=-1, sign-normalized so every
 * intermediate stays non-negative): A=X^2 B=Y^2 C=2Z^2 E=(X+Y)^2-A-B
 * G=B-A F=C-G H=A+B ; X3=EF Y3=GH Z3=FG T3=EH — 4 squarings + 4 muls
 * vs ge_add's 9 muls; the [L]P ladder is 252 of these per point */
static void ge_dbl(ge *r, const ge *p)
{
    fe A, B, C, E, F, G, H, t;

    fe_sq(A, p->X);
    fe_sq(B, p->Y);
    fe_sq(C, p->Z);
    fe_add(C, C, C);
    fe_add(t, p->X, p->Y);
    fe_sq(E, t);
    fe_sub(E, E, A);
    fe_carry(E);
    fe_sub(E, E, B);
    fe_carry(E);
    fe_sub(G, B, A);
    fe_carry(G);
    fe_sub(F, C, G);
    fe_carry(F);
    fe_add(H, A, B);
    fe_mul(r->X, E, F);
    fe_mul(r->Y, G, H);
    fe_mul(r->Z, F, G);
    fe_mul(r->T, E, H);
}

/* T-less doubling for doubling-only runs (dbl-2008-bbjlp shape, a=-1,
 * globally negated so every operand stays non-negative): 3M+4S vs
 * ge_dbl's 4M+4S.  Leaves p->T stale — callers must finish a run with
 * ge_dbl before the next ge_add. */
static void ge_dbl_p2(ge *r, const ge *p)
{
    fe B, C, D, G, H2, J, t;

    fe_add(t, p->X, p->Y);
    fe_sq(B, t);
    fe_sq(C, p->X);
    fe_sq(D, p->Y);
    fe_sq(H2, p->Z);
    fe_add(H2, H2, H2);
    fe_sub(G, D, C);            /* G = D - C  (= F in the EFD notes) */
    fe_carry(G);
    fe_sub(t, B, C);
    fe_carry(t);
    fe_sub(t, t, D);            /* t = B - C - D */
    fe_carry(t);
    fe_add(J, C, H2);
    fe_carry(J);
    fe_sub(J, J, D);            /* J = C + 2Z^2 - D (= -J in the notes) */
    fe_carry(J);
    fe_add(H2, C, D);           /* reuse: C + D */
    fe_mul(r->X, t, J);
    fe_mul(r->Y, G, H2);
    fe_mul(r->Z, G, J);
}

/* identity in extended coords: X = 0 and Y = Z (the other X=0 point,
 * (0,-1) of order 2, has Y = -Z and fails fe_eq) */
static int ge_is_ident(const ge *p)
{
    return fe_iszero(p->X) && fe_eq(p->Y, p->Z);
}

/* L = 2^252 + 27742317777372353535851937790883648493, little-endian —
 * the prime subgroup order */
static const uint8_t L_LE[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7,
    0xa2, 0xde, 0xf9, 0xde, 0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

/* prime-order-subgroup membership: [L]P == identity.  Fixed 4-bit
 * windows over the fixed scalar L: 252 doublings + ~45 additions (L's
 * nibbles 32..62 are zero, so the middle of the ladder is doubling-only).
 * ~one scalar multiplication per point — see the module header for why
 * nothing cheaper can be sound against the 8-torsion subgroup. */
static int ge_torsion_free(const ge *p)
{
    ge tbl[15], acc;
    tbl[0] = *p;
    for (int m = 2; m <= 15; m++) {
        if (m & 1)
            ge_add(&tbl[m - 1], &tbl[m - 2], p);
        else
            ge_dbl(&tbl[m - 1], &tbl[m / 2 - 1]);
    }
    ge_ident(&acc);
    int started = 0;
    for (int w = 63; w >= 0; w--) {
        unsigned d = (L_LE[w >> 1] >> ((w & 1) ? 4 : 0)) & 0xfu;
        if (started) {
            /* T-less doublings except when this window ends in an add
             * (ge_add is the only consumer of T; ge_is_ident is not) */
            ge_dbl_p2(&acc, &acc);
            ge_dbl_p2(&acc, &acc);
            ge_dbl_p2(&acc, &acc);
            if (d)
                ge_dbl(&acc, &acc);
            else
                ge_dbl_p2(&acc, &acc);
        }
        if (d) {
            ge_add(&acc, &acc, &tbl[d - 1]);
            started = 1;
        }
    }
    return ge_is_ident(&acc);
}

/* RFC 8032 §5.1.3 strict decode; returns 1 ok, 0 reject.  Stricter than
 * ref10's permissive fe_frombytes: a non-canonical y (>= p) is rejected
 * here — libsodium's byte-compare verify can never accept such an R and
 * its gate rejects such an A, so the aggregate plane must reject too
 * (verdict parity, tests/test_halfagg.py hostile lanes). */
static int ge_decompress(ge *p, const uint8_t *s)
{
    if (!bytes_canonical(s))
        return 0;
    int sign = s[31] >> 7;
    fe y, y2, u, v, v3, v7, x, vxx, chk;
    fe one;
    fe_1(one);
    fe_frombytes(y, s);
    fe_sq(y2, y);
    fe_sub(u, y2, one);
    fe_carry(u);
    fe_mul(v, fe_d, y2);
    fe_add(v, v, one);
    fe_carry(v);
    /* x = u v^3 (u v^7)^((p-5)/8) */
    fe_sq(v3, v);
    fe_mul(v3, v3, v);
    fe_sq(v7, v3);
    fe_mul(v7, v7, v);
    fe_mul(x, u, v7);
    fe_pow22523(x, x);
    fe_mul(x, x, v3);
    fe_mul(x, x, u);
    fe_sq(vxx, x);
    fe_mul(vxx, vxx, v);
    if (!fe_eq(vxx, u)) {
        fe_0(chk);
        fe_sub(chk, chk, u); /* -u */
        fe_carry(chk);
        if (!fe_eq(vxx, chk))
            return 0;
        fe_mul(x, x, fe_sqrtm1);
    }
    uint8_t xb[32];
    fe_tobytes(xb, x);
    int x_is_zero = 1;
    for (int i = 0; i < 32; i++)
        if (xb[i])
            x_is_zero = 0;
    if (x_is_zero && sign)
        return 0;
    if ((xb[0] & 1) != sign) {
        fe nx;
        fe_0(nx);
        fe_sub(nx, nx, x);
        fe_carry(nx);
        fe_copy(x, nx);
    }
    fe_copy(p->X, x);
    fe_copy(p->Y, y);
    fe_1(p->Z);
    fe_mul(p->T, x, y);
    return 1;
}

static void ge_compress(uint8_t *s, const ge *p)
{
    fe zinv, x, y;
    fe_pow(zinv, p->Z, EXP_PM2);
    fe_mul(x, p->X, zinv);
    fe_mul(y, p->Y, zinv);
    fe_tobytes(s, y);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    s[31] |= (xb[0] & 1) << 7;
}

/* raw limb (de)serialization for the host-local extended-point cache:
 * 4 coords x 5 limbs x 8 bytes = 160 bytes, limbs < 2^52 enforced on
 * load (arbitrary u64 limbs would overflow the 128-bit accumulators) */
#define GE_EXT_BYTES 160

static void ge_save(uint8_t *out, const ge *p)
{
    memcpy(out, p->X, 40);
    memcpy(out + 40, p->Y, 40);
    memcpy(out + 80, p->Z, 40);
    memcpy(out + 120, p->T, 40);
}

static int ge_load(ge *p, const uint8_t *in)
{
    memcpy(p->X, in, 40);
    memcpy(p->Y, in + 40, 40);
    memcpy(p->Z, in + 80, 40);
    memcpy(p->T, in + 120, 40);
    const uint64_t *limbs = (const uint64_t *)p;
    for (int i = 0; i < 20; i++)
        if (limbs[i] >> 52)
            return 0;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Pippenger multi-scalar multiplication                               */
/* ------------------------------------------------------------------ */

#define N_BUCKETS 255 /* digits 1..2^c-1, c <= 8 */

/* c-bit window digit w of a 256-bit little-endian scalar (c <= 8, so a
 * digit spans at most two bytes) */
static unsigned get_digit(const uint8_t *s, int w, int c)
{
    int bit = w * c;
    int byte = bit >> 3, sh = bit & 7;
    unsigned v = s[byte];
    if (byte + 1 < 32)
        v |= (unsigned)s[byte + 1] << 8;
    return (v >> sh) & ((1u << c) - 1u);
}

/* Pippenger window size for n points: the per-window bucket reduction
 * costs ~2*2^c additions REGARDLESS of n, so small slot buckets want
 * small windows (2^c ≈ n/2.5 balances point adds against reduction —
 * at n≈240 an 8-bit window pays 16k reduction adds for 6k useful ones
 * and loses to libsodium; a 5-bit window wins) */
static int window_bits(Py_ssize_t n)
{
    if (n < 90)
        return 4;
    if (n < 350)
        return 5;
    if (n < 900)
        return 6;
    if (n < 2200)
        return 7;
    return 8;
}

/* out = sum(scalar_i * P_i); scalars 32-byte LE, already < L (< 2^253). */
static void msm_run(uint8_t out[32], const ge *pts, const uint8_t *scalars,
                    Py_ssize_t n, ge *buckets)
{
    ge acc, sum, run;
    ge_ident(&acc);
    int c = window_bits(n);
    int n_windows = (256 + c - 1) / c;
    int n_buckets = (1 << c) - 1;
    int started = 0;
    for (int w = n_windows - 1; w >= 0; w--) {
        if (started)
            for (int k = 0; k < c; k++)
                ge_dbl(&acc, &acc);
        int used = 0;
        for (Py_ssize_t i = 0; i < n; i++) {
            unsigned d = get_digit(scalars + i * 32, w, c);
            if (!d)
                continue;
            if (!used) {
                for (int b = 0; b < n_buckets; b++)
                    ge_ident(&buckets[b]);
                used = 1;
            }
            ge_add(&buckets[d - 1], &buckets[d - 1], &pts[i]);
        }
        if (!used)
            continue;
        /* running-sum bucket reduction: sum = Σ d*bucket[d] */
        ge_ident(&run);
        ge_ident(&sum);
        for (int b = n_buckets - 1; b >= 0; b--) {
            ge_add(&run, &run, &buckets[b]);
            ge_add(&sum, &sum, &run);
        }
        ge_add(&acc, &acc, &sum);
        started = 1;
    }
    ge_compress(out, &acc);
}

/* ------------------------------------------------------------------ */
/* module surface                                                     */
/* ------------------------------------------------------------------ */

/* decompress(points: n*32 bytes) -> (ok: n bytes, ext: n*160 bytes) */
static PyObject *py_decompress(PyObject *self, PyObject *args)
{
    Py_buffer pb;
    if (!PyArg_ParseTuple(args, "y*", &pb))
        return NULL;
    if (pb.len % 32) {
        PyBuffer_Release(&pb);
        PyErr_SetString(PyExc_ValueError, "points must be n*32 bytes");
        return NULL;
    }
    Py_ssize_t n = pb.len / 32;
    PyObject *ok_o = PyBytes_FromStringAndSize(NULL, n);
    PyObject *ext_o = PyBytes_FromStringAndSize(NULL, n * GE_EXT_BYTES);
    if (!ok_o || !ext_o) {
        Py_XDECREF(ok_o);
        Py_XDECREF(ext_o);
        PyBuffer_Release(&pb);
        return NULL;
    }
    uint8_t *ok = (uint8_t *)PyBytes_AS_STRING(ok_o);
    uint8_t *ext = (uint8_t *)PyBytes_AS_STRING(ext_o);
    const uint8_t *pts = (const uint8_t *)pb.buf;
    Py_BEGIN_ALLOW_THREADS
    for (long long i = 0; i < n; i++) {
        ge g;
        if (ge_decompress(&g, pts + i * 32)) {
            ok[i] = 1;
            ge_save(ext + i * GE_EXT_BYTES, &g);
        } else {
            ok[i] = 0;
            memset(ext + i * GE_EXT_BYTES, 0, GE_EXT_BYTES);
        }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&pb);
    return Py_BuildValue("NN", ok_o, ext_o);
}

/* msm_ext(ext: n*160 bytes, scalars: n*32 bytes) -> 32-byte compressed */
static PyObject *py_msm_ext(PyObject *self, PyObject *args)
{
    Py_buffer eb, sb;
    if (!PyArg_ParseTuple(args, "y*y*", &eb, &sb))
        return NULL;
    if (eb.len % GE_EXT_BYTES || sb.len % 32 ||
        eb.len / GE_EXT_BYTES != sb.len / 32) {
        PyBuffer_Release(&eb);
        PyBuffer_Release(&sb);
        PyErr_SetString(PyExc_ValueError,
                        "need n*160-byte points and n*32-byte scalars");
        return NULL;
    }
    Py_ssize_t n = eb.len / GE_EXT_BYTES;
    ge *pts = NULL;
    ge *buckets = NULL;
    uint8_t out[32];
    int bad = 0;
    const uint8_t *ext = (const uint8_t *)eb.buf;
    const uint8_t *scalars = (const uint8_t *)sb.buf;
    Py_BEGIN_ALLOW_THREADS
    pts = malloc((n ? n : 1) * sizeof(ge));
    buckets = malloc(N_BUCKETS * sizeof(ge));
    if (!pts || !buckets) {
        bad = 2;
    } else {
        for (long long i = 0; i < n; i++)
            if (!ge_load(&pts[i], ext + i * GE_EXT_BYTES)) {
                bad = 1;
                break;
            }
        if (!bad)
            msm_run(out, pts, scalars, n, buckets);
    }
    free(pts);
    free(buckets);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&eb);
    PyBuffer_Release(&sb);
    if (bad == 2)
        return PyErr_NoMemory();
    if (bad) {
        PyErr_SetString(PyExc_ValueError, "malformed extended-point limbs");
        return NULL;
    }
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

/* msm(points: n*32 compressed, scalars: n*32) -> 32-byte compressed;
 * raises ValueError on any undecodable point (tests/oracle surface —
 * the aggregate plane itself uses decompress + msm_ext so one hostile
 * point fails one item, not the batch) */
static PyObject *py_msm(PyObject *self, PyObject *args)
{
    Py_buffer pb, sb;
    if (!PyArg_ParseTuple(args, "y*y*", &pb, &sb))
        return NULL;
    if (pb.len % 32 || sb.len % 32 || pb.len != sb.len) {
        PyBuffer_Release(&pb);
        PyBuffer_Release(&sb);
        PyErr_SetString(PyExc_ValueError,
                        "need n*32-byte points and n*32-byte scalars");
        return NULL;
    }
    Py_ssize_t n = pb.len / 32;
    ge *pts = NULL;
    ge *buckets = NULL;
    uint8_t out[32];
    Py_ssize_t bad_at = -1;
    int oom = 0;
    const uint8_t *cpts = (const uint8_t *)pb.buf;
    const uint8_t *scalars = (const uint8_t *)sb.buf;
    Py_BEGIN_ALLOW_THREADS
    pts = malloc((n ? n : 1) * sizeof(ge));
    buckets = malloc(N_BUCKETS * sizeof(ge));
    if (!pts || !buckets) {
        oom = 1;
    } else {
        for (long long i = 0; i < n; i++)
            if (!ge_decompress(&pts[i], cpts + i * 32)) {
                bad_at = i;
                break;
            }
        if (bad_at < 0)
            msm_run(out, pts, scalars, n, buckets);
    }
    free(pts);
    free(buckets);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&pb);
    PyBuffer_Release(&sb);
    if (oom)
        return PyErr_NoMemory();
    if (bad_at >= 0) {
        PyErr_Format(PyExc_ValueError, "bad point at index %zd", bad_at);
        return NULL;
    }
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

/* torsion_free(ext: n*160 bytes) -> ok: n bytes (1 = prime-order) */
static PyObject *py_torsion_free(PyObject *self, PyObject *args)
{
    Py_buffer eb;
    if (!PyArg_ParseTuple(args, "y*", &eb))
        return NULL;
    if (eb.len % GE_EXT_BYTES) {
        PyBuffer_Release(&eb);
        PyErr_SetString(PyExc_ValueError, "need n*160-byte points");
        return NULL;
    }
    Py_ssize_t n = eb.len / GE_EXT_BYTES;
    PyObject *ok_o = PyBytes_FromStringAndSize(NULL, n);
    if (!ok_o) {
        PyBuffer_Release(&eb);
        return NULL;
    }
    uint8_t *ok = (uint8_t *)PyBytes_AS_STRING(ok_o);
    const uint8_t *ext = (const uint8_t *)eb.buf;
    int bad = 0;
    Py_BEGIN_ALLOW_THREADS
    for (long long i = 0; i < n; i++) {
        ge g;
        if (!ge_load(&g, ext + i * GE_EXT_BYTES)) {
            bad = 1;
            break;
        }
        ok[i] = ge_torsion_free(&g) ? 1 : 0;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&eb);
    if (bad) {
        Py_DECREF(ok_o);
        PyErr_SetString(PyExc_ValueError, "malformed extended-point limbs");
        return NULL;
    }
    return ok_o;
}

static PyMethodDef methods[] = {
    {"decompress", py_decompress, METH_VARARGS,
     "decompress(points32xN) -> (ok_flags, extended_limbs)"},
    {"msm_ext", py_msm_ext, METH_VARARGS,
     "msm_ext(extended_limbs, scalars32xN) -> compressed sum"},
    {"msm", py_msm, METH_VARARGS,
     "msm(points32xN, scalars32xN) -> compressed sum"},
    {"torsion_free", py_torsion_free, METH_VARARGS,
     "torsion_free(extended_limbs) -> ok_flags ([L]P == identity)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_halfagg", NULL, -1, methods,
};

PyMODINIT_FUNC
PyInit__halfagg(void)
{
    return PyModule_Create(&moduledef);
}
