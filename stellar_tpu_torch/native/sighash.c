/* sighash — CPython extension: the ed25519 batch-verify HOST STAGE in C.
 *
 * A copy of the JAX package's native/sighash.c without its two test
 * hooks (_sha512_rax, _reduce512), with an optional stamp buffer on
 * stage() and stage_raw() (clock stamps of the GIL-held and GIL-released
 * parts, for the span tracer), and with stage_rows() (stage_raw()'s bytes
 * item-major), built by stellar_tpu_torch/native into the port's own
 * build directory.  Entry points: stage() and stage_rows() (the verify
 * plane's host-hash and device-hash staging), stage_raw(), sodium_verify(),
 * and sha256_batch() / bucket_hash_frames() (the bucket-hash plane's
 * native backend, bucket/hashplane.py).
 *
 * The verify kernel needs four byte columns per item (A, R, s, and
 * h = SHA-512(R‖A‖M) mod L); producing them in Python costs per-item
 * hashlib + bigint work under the GIL, which starves the stager thread
 * that is supposed to overlap staging with device compute.  This
 * module does the whole per-item host stage in one C call over the
 * chunk:
 *
 *   - libsodium's strict-input gate (canonical s < L, canonical A with
 *     the sign bit masked, small-order R/A against the caller-supplied
 *     blacklist — the same accept set as ops/ref25519.strict_input_ok);
 *   - h = SHA-512(R‖A‖M) mod L, with a single-compress fast path for
 *     preimages ≤ 111 bytes (the dominant verify class hashes a fixed
 *     96-byte R‖A‖contents-hash preimage: one padded block, no length
 *     loop);
 *   - the packed TRANSPOSED staging layout the device upload wants:
 *     a (128, stride) uint8 buffer whose rows 0:32/32:64/64:96/96:128
 *     are the A/R/s/h byte columns, written via 64-item cache tiles.
 *
 * The GIL is released for the whole compute and an internal pthread pool
 * fans out over tiles for large batches, so a stager thread running this
 * call genuinely overlaps device execution (and other Python threads keep
 * running — the property ctypes gives bucketmerge.c for free).
 *
 * SHA-512 is FIPS 180-4 from scratch (same policy as bucketmerge.c's
 * SHA-256); the mod-L reduction folds at the 2^252 boundary against the
 * 125-bit tail c = L - 2^252, shrinking ≥127 bits per fold (3 folds from
 * 512 bits).  tests/test_torch_sigbackend.py and test_torch_sha512.py
 * hold stage() and stage_raw() byte for byte against the JAX package's
 * build of the same stage; test_torch_hashplane.py holds the SHA-256
 * entries against hashlib.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

/* ------------------------------------------------------------------ */
/* SHA-512 (FIPS 180-4)                                               */
/* ------------------------------------------------------------------ */

static const uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

static const uint64_t H512_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static inline uint64_t
rotr64(uint64_t x, int n)
{
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t
load_be64(const uint8_t *p)
{
    return ((uint64_t)p[0] << 56) | ((uint64_t)p[1] << 48) |
           ((uint64_t)p[2] << 40) | ((uint64_t)p[3] << 32) |
           ((uint64_t)p[4] << 24) | ((uint64_t)p[5] << 16) |
           ((uint64_t)p[6] << 8) | (uint64_t)p[7];
}

static inline void
store_be64(uint8_t *p, uint64_t v)
{
    p[0] = (uint8_t)(v >> 56); p[1] = (uint8_t)(v >> 48);
    p[2] = (uint8_t)(v >> 40); p[3] = (uint8_t)(v >> 32);
    p[4] = (uint8_t)(v >> 24); p[5] = (uint8_t)(v >> 16);
    p[6] = (uint8_t)(v >> 8);  p[7] = (uint8_t)v;
}

static inline uint64_t
load_le64(const uint8_t *p)
{
    uint64_t v;
    memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    v = __builtin_bswap64(v);
#endif
    return v;
}

static void
sha512_compress(uint64_t st[8], const uint8_t blk[128])
{
    uint64_t w[80];
    int t;
    for (t = 0; t < 16; t++)
        w[t] = load_be64(blk + 8 * t);
    for (t = 16; t < 80; t++) {
        uint64_t s0 = rotr64(w[t - 15], 1) ^ rotr64(w[t - 15], 8) ^
                      (w[t - 15] >> 7);
        uint64_t s1 = rotr64(w[t - 2], 19) ^ rotr64(w[t - 2], 61) ^
                      (w[t - 2] >> 6);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (t = 0; t < 80; t++) {
        uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + K512[t] + w[t];
        uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

/* SHA-512 of R(32) ‖ A(32) ‖ M.  Preimages ≤ 111 bytes (M ≤ 47) pad into
 * a single block — one compress, no streaming state; the dominant verify
 * class (M = a 32-byte contents hash, preimage 96 bytes) always takes
 * this path. */
static void
sha512_rax(const uint8_t r[32], const uint8_t a[32], const uint8_t *m,
           size_t mlen, uint8_t out[64])
{
    uint64_t st[8];
    uint8_t buf[128];
    size_t total = 64 + mlen;
    int i;

    memcpy(st, H512_IV, sizeof st);
    if (total <= 111) {
        memcpy(buf, r, 32);
        memcpy(buf + 32, a, 32);
        if (mlen)
            memcpy(buf + 64, m, mlen);
        buf[total] = 0x80;
        memset(buf + total + 1, 0, 112 - (total + 1));
        store_be64(buf + 112, 0);
        store_be64(buf + 120, (uint64_t)total << 3);
        sha512_compress(st, buf);
    } else {
        size_t fill, rem = mlen;
        const uint8_t *p = m;
        memcpy(buf, r, 32);
        memcpy(buf + 32, a, 32);
        if (rem >= 64) {
            memcpy(buf + 64, p, 64);
            sha512_compress(st, buf);
            p += 64; rem -= 64; fill = 0;
        } else {
            /* 48 <= mlen < 64: the only block stays partial */
            memcpy(buf + 64, p, rem);
            fill = 64 + rem; rem = 0;
        }
        while (rem >= 128) {
            sha512_compress(st, p);
            p += 128; rem -= 128;
        }
        if (rem) {
            memcpy(buf + fill, p, rem);
            fill += rem;
        }
        buf[fill++] = 0x80;
        if (fill > 112) {
            memset(buf + fill, 0, 128 - fill);
            sha512_compress(st, buf);
            fill = 0;
        }
        memset(buf + fill, 0, 112 - fill);
        store_be64(buf + 112, (uint64_t)(total >> 61));
        store_be64(buf + 120, (uint64_t)total << 3);
        sha512_compress(st, buf);
    }
    for (i = 0; i < 8; i++)
        store_be64(out + 8 * i, st[i]);
}

/* ------------------------------------------------------------------ */
/* reduction mod L = 2^252 + c,  c = 27742317…648493  (125 bits)      */
/* ------------------------------------------------------------------ */

#define C0 0x5812631a5cf5d3edULL /* c low word */
#define C1 0x14def9dea2f79cd6ULL /* c high word (61 bits) */

static const uint64_t L_W[4] = {C0, C1, 0, 0x1000000000000000ULL};
static const uint64_t P_W[4] = {
    0xffffffffffffffedULL, 0xffffffffffffffffULL,
    0xffffffffffffffffULL, 0x7fffffffffffffffULL,
};

/* t[0..nb+1] = b[0..nb-1] * c.  Column accumulation never overflows the
 * 128-bit accumulator: each column sums at most one b*C0 (< 2^128-2^65),
 * one b*C1 (< 2^125 — C1 is 61 bits) and a < 2^64 carry. */
static void
mul_c(const uint64_t *b, int nb, uint64_t *t)
{
    unsigned __int128 acc = 0;
    int k;
    for (k = 0; k < nb + 2; k++) {
        if (k < nb)
            acc += (unsigned __int128)b[k] * C0;
        if (k >= 1 && k - 1 < nb)
            acc += (unsigned __int128)b[k - 1] * C1;
        t[k] = (uint64_t)acc;
        acc >>= 64;
    }
}

static int
trim_words(const uint64_t *x, int n)
{
    while (n > 0 && x[n - 1] == 0)
        n--;
    return n;
}

/* -1 / 0 / +1 for a (na words) vs b (nb words) */
static int
cmp_n(const uint64_t *a, int na, const uint64_t *b, int nb)
{
    int i;
    na = trim_words(a, na);
    nb = trim_words(b, nb);
    if (na != nb)
        return na < nb ? -1 : 1;
    for (i = na - 1; i >= 0; i--)
        if (a[i] != b[i])
            return a[i] < b[i] ? -1 : 1;
    return 0;
}

/* a -= b, a >= b, nb <= na */
static void
sub_n(uint64_t *a, int na, const uint64_t *b, int nb)
{
    uint64_t borrow = 0;
    int i;
    for (i = 0; i < na; i++) {
        uint64_t bi = i < nb ? b[i] : 0;
        uint64_t d = a[i] - bi;
        uint64_t nb2 = (a[i] < bi) || (d < borrow);
        a[i] = d - borrow;
        borrow = nb2;
    }
}

/* r = x mod L; x has nw <= 9 words and is destroyed.  Folds at the 2^252
 * boundary: x = A + B·2^252 ≡ A − B·c (mod L); when the subtraction goes
 * negative, recurse on B·c − A (≥127 bits smaller each level) and flip:
 * r = L − reduce(B·c − A). */
static void
mod_L(uint64_t *x, int nw, uint64_t r[4])
{
    uint64_t A[4], B[8], T[10], d[4];
    int nb, nt, i;

    nw = trim_words(x, nw);
    if (nw <= 4 && cmp_n(x, nw, L_W, 4) < 0) {
        for (i = 0; i < 4; i++)
            r[i] = i < nw ? x[i] : 0;
        return;
    }
    A[0] = x[0];
    A[1] = nw > 1 ? x[1] : 0;
    A[2] = nw > 2 ? x[2] : 0;
    A[3] = (nw > 3 ? x[3] : 0) & 0x0fffffffffffffffULL;
    nb = nw - 3;
    for (i = 0; i < nb; i++)
        B[i] = (x[i + 3] >> 60) | (i + 4 < nw ? x[i + 4] << 4 : 0);
    nb = trim_words(B, nb);
    if (nb == 0) { /* x < 2^252 yet >= L is impossible; x was >= L via
                      the 253rd bit only — handled by the fold below,
                      so nb == 0 cannot occur except x < 2^252, already
                      returned.  Defensive: */
        memcpy(r, A, sizeof A);
        return;
    }
    mul_c(B, nb, T);
    nt = trim_words(T, nb + 2);
    if (cmp_n(T, nt, A, 4) <= 0) {
        /* r = A - T: already < 2^252 < L */
        sub_n(A, 4, T, nt);
        memcpy(r, A, sizeof A);
        return;
    }
    sub_n(T, nt, A, 4);
    mod_L(T, nt, d);
    if (trim_words(d, 4) == 0) {
        memset(r, 0, 4 * sizeof(uint64_t));
    } else {
        memcpy(r, L_W, sizeof L_W);
        sub_n(r, 4, d, 4);
    }
}

/* h = SHA-512 digest (64 bytes) interpreted little-endian, mod L,
 * written back as 32 little-endian bytes */
static void
reduce512_le(const uint8_t digest[64], uint8_t out[32])
{
    uint64_t x[9], r[4];
    int i;
    for (i = 0; i < 8; i++)
        x[i] = load_le64(digest + 8 * i);
    x[8] = 0;
    mod_L(x, 8, r);
    for (i = 0; i < 4; i++) {
        uint64_t v = r[i];
        int j;
        for (j = 0; j < 8; j++) {
            out[8 * i + j] = (uint8_t)v;
            v >>= 8;
        }
    }
}

/* ------------------------------------------------------------------ */
/* strict-input gate (libsodium crypto_sign_verify_detached preamble)  */
/* ------------------------------------------------------------------ */

static int
lt_le32(const uint8_t le32[32], const uint64_t bound[4])
{
    int i;
    for (i = 3; i >= 0; i--) {
        uint64_t w = load_le64(le32 + 8 * i);
        if (w != bound[i])
            return w < bound[i];
    }
    return 0;
}

static int
small_order(const uint8_t e[32], const uint8_t *bl, int nbl)
{
    uint8_t m[32];
    int k;
    memcpy(m, e, 32);
    m[31] &= 0x7f; /* the blacklist compare ignores the sign bit */
    for (k = 0; k < nbl; k++)
        if (memcmp(m, bl + 32 * k, 32) == 0)
            return 1;
    return 0;
}

static int
gate_ok(const uint8_t *pk, const uint8_t *sig, const uint8_t *bl, int nbl)
{
    uint8_t am[32];
    if (!lt_le32(sig + 32, L_W)) /* canonical s */
        return 0;
    if (small_order(sig, bl, nbl)) /* small-order R */
        return 0;
    memcpy(am, pk, 32);
    am[31] &= 0x7f;
    if (!lt_le32(am, P_W)) /* canonical A (sign bit masked) */
        return 0;
    if (small_order(pk, bl, nbl)) /* small-order A */
        return 0;
    return 1;
}

/* ------------------------------------------------------------------ */
/* the batch job: gate + hash + transposed staging, tile-parallel      */
/* ------------------------------------------------------------------ */

#define TILE 64       /* items per transpose tile (8/10 KB scratch) */
#define PAR_MIN 2048  /* below this the fanout overhead isn't worth it */
#define MAX_WORKERS 8

/* device-hash staging layout (ops/sha512.py DH_ROWS): the device runs
 * the SHA-512 stage, so single-block items upload RAW message bytes and
 * the host keeps only the gate.  Multi-block (>111-byte preimage)
 * residuals ride the existing C hash path right here and merge via the
 * flag row. */
#define DH_ROWS 160
#define DH_ROW_M 96
#define DH_ROW_MLEN 144
#define DH_ROW_FLAG 145
#define DH_MAX_MSG 47 /* 64 + mlen <= 111: single padded block */

typedef struct {
    const uint8_t *pk; Py_ssize_t pk_len;
    const uint8_t *msg; Py_ssize_t msg_len;
    const uint8_t *sig; Py_ssize_t sig_len;
    PyObject *pk_o, *msg_o, *sig_o; /* strong refs for the pass duration */
} Item;

typedef struct {
    PyObject *const *tups; /* the lanes' item tuples, a strong ref each */
    size_t n;
    uint8_t *out;   /* (rowsz, stride) row-major; (stride, DH_ROWS) for
                     * stage_rows() */
    size_t stride;
    size_t rowsz;   /* 128 (host-hash) or DH_ROWS (device-hash raw) */
    int raw;        /* 1 = device-hash staging (gate only, raw M) */
    uint8_t *ok;    /* n bytes; GIL_LANE marks a lane the pass left */
    const uint8_t *bl;
    int nbl;
    size_t next_tile; /* atomic work counter */
    size_t rejects;   /* atomic */
    size_t flagged;   /* atomic: stage_rows() lanes with flag 1 */
    size_t gil_lanes; /* atomic: lanes marked GIL_LANE */
} Job;

/* ok[i] of a lane that the GIL-released pass left to stage_gil_lanes: a
 * slot of its tuple is not exactly bytes.  Its row stays zero until then. */
#define GIL_LANE 2

/* lane t's Item, read through its tuple with the GIL released.  The stage
 * holds a reference on the tuple, which holds its slots, and neither a
 * tuple nor a bytes object ever changes, so nothing read here can change
 * or be freed whatever other threads do to the caller's sequence.  Only
 * exact bytes pass, told by the type's address alone: the class of a
 * bytes subclass instance can be reassigned, freeing the old class, so
 * its type object is not read here.  Returns 0 for such a lane. */
static inline __attribute__((always_inline)) int
lane_item(PyObject *t, Item *it)
{
    PyObject *const *s =
        ((PyTupleObject *)t)->ob_item + ((PyVarObject *)t)->ob_size - 3;
    PyObject *pk = s[0], *msg = s[1], *sig = s[2];
    if (Py_TYPE(pk) != &PyBytes_Type || Py_TYPE(msg) != &PyBytes_Type ||
        Py_TYPE(sig) != &PyBytes_Type)
        return 0;
    it->pk = (const uint8_t *)((PyBytesObject *)pk)->ob_sval;
    it->pk_len = ((PyVarObject *)pk)->ob_size;
    it->msg = (const uint8_t *)((PyBytesObject *)msg)->ob_sval;
    it->msg_len = ((PyVarObject *)msg)->ob_size;
    it->sig = (const uint8_t *)((PyBytesObject *)sig)->ob_sval;
    it->sig_len = ((PyVarObject *)sig)->ob_size;
    return 1;
}

/* The lanes name their tuples in the caller's order, so the pass chases
 * two pointers a lane to memory that no prefetcher predicts: the tuple,
 * then its three bytes objects.  It warms them ahead: lane i + 2 * PF_D's
 * tuple, and lane i + PF_D's objects through its tuple, by then warm (the
 * stage's reference keeps both alive, as for lane_item): each object's
 * header and the line of its last byte read.  On the benchmark cell's
 * host CPU 8, 16 and 24 lanes gave the same times, and the last lines
 * saved 0.2-0.5 ms of a 32,768-lane pass (PERF.md). */
#define PF_D 16

static inline __attribute__((always_inline)) void
prefetch_lanes(PyObject *const *tups, size_t i, size_t n)
{
    if (i + 2 * PF_D < n) {
        const char *u = (const char *)tups[i + 2 * PF_D];
        __builtin_prefetch(u);      /* its header */
        __builtin_prefetch(u + 40); /* its slots, where they cross a line */
    }
    if (i + PF_D < n) {
        PyObject *u = tups[i + PF_D];
        PyObject *const *s =
            ((PyTupleObject *)u)->ob_item + ((PyVarObject *)u)->ob_size - 3;
        __builtin_prefetch(s[0]);                   /* pk: 32 bytes at +32 */
        __builtin_prefetch((const char *)s[0] + 63);
        __builtin_prefetch(s[1]);                   /* msg: a 32-byte hash */
        __builtin_prefetch((const char *)s[1] + 63);
        __builtin_prefetch(s[2]);                   /* sig: 64 bytes at +32 */
        __builtin_prefetch((const char *)s[2] + 95);
    }
}

/* row layout per item: [0:32) A  [32:64) R  [64:96) s  [96:128) h.
 * Always inlined, as item_row_raw is. */
static inline __attribute__((always_inline)) int
item_row(const Item *it, uint8_t row[128], const uint8_t *bl, int nbl)
{
    uint8_t digest[64];
    if (it->pk_len != 32 || it->sig_len != 64) {
        memset(row, 0, 128);
        return 0;
    }
    memcpy(row, it->pk, 32);
    memcpy(row + 32, it->sig, 32);
    memcpy(row + 64, it->sig + 32, 32);
    if (!gate_ok(it->pk, it->sig, bl, nbl)) {
        /* rejected lanes never reach a real device compare — skip the
         * hash (hostile floods stay cheap) and zero the h column */
        memset(row + 96, 0, 32);
        return 0;
    }
    sha512_rax(it->sig, it->pk, it->msg, (size_t)it->msg_len, digest);
    reduce512_le(digest, row + 96);
    return 1;
}

/* device-hash row (DH_ROWS wide): the host runs ONLY the strict gate.
 * Single-block items (mlen <= 47, the dominant 96-byte R‖A‖M class)
 * carry raw message bytes + mlen with flag = 1 — the device hashes;
 * multi-block residuals keep the existing C hash path (flag = 0, h in
 * rows 96:128) and merge at the same kernel.  Always inlined, so the
 * per-lane loops of both passes (run_job_tiles, run_job_records) make no
 * call. */
static inline __attribute__((always_inline)) int
item_row_raw(const Item *it, uint8_t row[DH_ROWS], const uint8_t *bl,
             int nbl)
{
    uint8_t digest[64];
    memset(row + 96, 0, DH_ROWS - 96);
    if (it->pk_len != 32 || it->sig_len != 64) {
        memset(row, 0, 96);
        return 0;
    }
    memcpy(row, it->pk, 32);
    memcpy(row + 32, it->sig, 32);
    memcpy(row + 64, it->sig + 32, 32);
    if (!gate_ok(it->pk, it->sig, bl, nbl)) {
        /* fully inert lane: byte-identical with the Python staging twin
         * (and no hostile bytes ride the upload) */
        memset(row, 0, 96);
        return 0;
    }
    if (it->msg_len <= DH_MAX_MSG) {
        if (it->msg_len)
            memcpy(row + DH_ROW_M, it->msg, (size_t)it->msg_len);
        row[DH_ROW_MLEN] = (uint8_t)it->msg_len;
        row[DH_ROW_FLAG] = 1;
    } else {
        sha512_rax(it->sig, it->pk, it->msg, (size_t)it->msg_len, digest);
        reduce512_le(digest, row + 96);
        /* mlen/flag stay 0: the device selects the uploaded h */
    }
    return 1;
}

/* stage() and stage_raw()'s pass, over 64-lane tiles.  Like
 * run_job_records, in a section of its own (after .text), so that what
 * changes in .text moves neither pass. */
static void __attribute__((section(".text.stage_tiles")))
run_job_tiles(void *arg)
{
    Job *j = arg;
    uint8_t rows[TILE][DH_ROWS];
    size_t ntiles = (j->n + TILE - 1) / TILE;
    size_t rej = 0, gil = 0, t, rowsz = j->rowsz;
    while ((t = __atomic_fetch_add(&j->next_tile, 1, __ATOMIC_RELAXED)) <
           ntiles) {
        size_t lo = t * TILE;
        size_t hi = lo + TILE;
        size_t i, cnt, r;
        if (hi > j->n)
            hi = j->n;
        cnt = hi - lo;
        for (i = lo; i < hi; i++) {
            Item it;
            int ok;
            prefetch_lanes(j->tups, i, j->n);
            if (!lane_item(j->tups[i], &it)) {
                memset(rows[i - lo], 0, rowsz);
                j->ok[i] = GIL_LANE;
                gil++;
                continue;
            }
            ok = j->raw ? item_row_raw(&it, rows[i - lo], j->bl, j->nbl)
                        : item_row(&it, rows[i - lo], j->bl, j->nbl);
            j->ok[i] = (uint8_t)ok;
            if (!ok)
                rej++;
        }
        /* transpose the tile: rows[k][r] -> out[r][lo + k]; reads stay in
         * the 10 KB scratch, writes are 64-byte contiguous runs per row */
        for (r = 0; r < rowsz; r++) {
            uint8_t *dst = j->out + (size_t)r * j->stride + lo;
            for (i = 0; i < cnt; i++)
                dst[i] = rows[i][r];
        }
    }
    if (rej)
        __atomic_fetch_add(&j->rejects, rej, __ATOMIC_RELAXED);
    if (gil)
        __atomic_fetch_add(&j->gil_lanes, gil, __ATOMIC_RELAXED);
}

/* stage_rows()'s pass: the same device-hash rows, each written in place
 * as lane i's DH_ROWS bytes at out + i * DH_ROWS.  Lanes lie item-major,
 * so the writes run on in one stream.  The transposed layout spreads each
 * 64-lane tile over DH_ROWS rows a stride apart, more write streams than
 * a core's prefetcher follows; the card transposes instead
 * (csrc/sha512_h.cu, dh_rows_to_cols_kernel).  In a section of its own,
 * which the linker lays after .text, so this pass moves none of the
 * functions emitted before it: their loops run ~20 % slower at some
 * offsets (stage_raw's when this pass came first, PERF.md). */
static void __attribute__((section(".text.stage_rows")))
run_job_records(void *arg)
{
    Job *j = arg;
    size_t ntiles = (j->n + TILE - 1) / TILE;
    size_t rej = 0, flagged = 0, gil = 0, t;
    while ((t = __atomic_fetch_add(&j->next_tile, 1, __ATOMIC_RELAXED)) <
           ntiles) {
        size_t i, hi = (t + 1) * TILE;
        if (hi > j->n)
            hi = j->n;
        for (i = t * TILE; i < hi; i++) {
            uint8_t *row = j->out + i * DH_ROWS;
            Item it;
            int ok;
            prefetch_lanes(j->tups, i, j->n);
            if (!lane_item(j->tups[i], &it)) {
                memset(row, 0, DH_ROWS);
                j->ok[i] = GIL_LANE;
                gil++;
                continue;
            }
            ok = item_row_raw(&it, row, j->bl, j->nbl);
            j->ok[i] = (uint8_t)ok;
            if (!ok)
                rej++;
            flagged += row[DH_ROW_FLAG];
        }
    }
    if (rej)
        __atomic_fetch_add(&j->rejects, rej, __ATOMIC_RELAXED);
    if (flagged)
        __atomic_fetch_add(&j->flagged, flagged, __ATOMIC_RELAXED);
    if (gil)
        __atomic_fetch_add(&j->gil_lanes, gil, __ATOMIC_RELAXED);
}

/* -- persistent worker pool (created on first large batch) ---------- */

static pthread_mutex_t pool_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t pool_go = PTHREAD_COND_INITIALIZER;
static pthread_cond_t pool_done = PTHREAD_COND_INITIALIZER;
/* one fanned-out job at a time: a second concurrent caller (two stager
 * threads, or a stage() racing a sodium_verify()) must not clobber
 * pool_fn/pool_arg/pool_active — it runs its own job inline instead
 * (see the trylock at each call site).  The job is a generic
 * (function, argument) pair so the same pool serves the staging tiles
 * AND the libsodium strict-verify tiles. */
static pthread_mutex_t pool_busy = PTHREAD_MUTEX_INITIALIZER;
static int pool_workers = 0;
static unsigned long pool_gen = 0;
static int pool_active = 0;
static void (*pool_fn)(void *) = NULL;
static void *pool_arg = NULL;

static void *
worker_main(void *arg)
{
    unsigned long seen = 0;
    (void)arg;
    pthread_mutex_lock(&pool_mu);
    for (;;) {
        while (pool_gen == seen)
            pthread_cond_wait(&pool_go, &pool_mu);
        seen = pool_gen;
        void (*fn)(void *) = pool_fn;
        void *a = pool_arg;
        pthread_mutex_unlock(&pool_mu);
        fn(a);
        pthread_mutex_lock(&pool_mu);
        if (--pool_active == 0)
            pthread_cond_signal(&pool_done);
    }
    return NULL;
}

static int
hw_threads(void)
{
    long n = sysconf(_SC_NPROCESSORS_ONLN);
    return n > 0 ? (int)n : 1;
}

/* must hold pool_mu */
static void
ensure_workers(int want)
{
    while (pool_workers < want) {
        pthread_t tid;
        pthread_attr_t attr;
        if (pthread_attr_init(&attr) != 0)
            break;
        pthread_attr_setdetachstate(&attr, PTHREAD_CREATE_DETACHED);
        if (pthread_create(&tid, &attr, worker_main, NULL) != 0) {
            pthread_attr_destroy(&attr);
            break; /* fall back to fewer (possibly zero) helpers */
        }
        pthread_attr_destroy(&attr);
        pool_workers++;
    }
}

static void
run_parallel(void (*fn)(void *), void *arg)
{
    pthread_mutex_lock(&pool_mu);
    ensure_workers(hw_threads() - 1 < MAX_WORKERS ? hw_threads() - 1
                                                  : MAX_WORKERS);
    pool_fn = fn;
    pool_arg = arg;
    pool_active = pool_workers;
    pool_gen++;
    pthread_cond_broadcast(&pool_go);
    pthread_mutex_unlock(&pool_mu);
    fn(arg); /* the calling thread works too */
    pthread_mutex_lock(&pool_mu);
    while (pool_active)
        pthread_cond_wait(&pool_done, &pool_mu);
    pool_fn = NULL;
    pool_arg = NULL;
    pthread_mutex_unlock(&pool_mu);
}

/* -- libsodium strict-verify tiles (the pure-CPU fallback leg) ------- */
/* The caller (crypto/sigbackend._sodium_verify_native) hands us the
 * ADDRESS of crypto_sign_verify_detached out of the already-loaded
 * libsodium; the tiles call it directly with the GIL released, so the
 * whole cache-miss batch fans over the worker pool with zero per-item
 * Python dispatch.  Length prechecks mirror sodium.verify_detached
 * (len(sig)!=64 or len(pk)!=32 -> False) so results are byte-identical
 * to the serial loop. */

typedef int (*sodium_verify_fn)(const unsigned char *sig,
                                const unsigned char *msg,
                                unsigned long long msg_len,
                                const unsigned char *pk);

typedef struct {
    const Item *items;
    size_t n;
    uint8_t *ok;       /* n bytes of 0/1 verdicts */
    sodium_verify_fn fn;
    size_t next_tile;  /* atomic work counter */
} VJob;

/* a libsodium verify is ~50 us — small tiles keep the tail balanced,
 * and fanout pays off at far smaller batches than the hashing stage */
#define VTILE 32
#define VPAR_MIN 64

static void
run_verify_tiles(void *arg)
{
    VJob *j = arg;
    size_t ntiles = (j->n + VTILE - 1) / VTILE, t;
    while ((t = __atomic_fetch_add(&j->next_tile, 1, __ATOMIC_RELAXED)) <
           ntiles) {
        size_t lo = t * VTILE;
        size_t hi = lo + VTILE;
        size_t i;
        if (hi > j->n)
            hi = j->n;
        for (i = lo; i < hi; i++) {
            const Item *it = &j->items[i];
            j->ok[i] = (uint8_t)(it->pk_len == 32 && it->sig_len == 64 &&
                                 j->fn(it->sig, it->msg,
                                       (unsigned long long)it->msg_len,
                                       it->pk) == 0);
        }
    }
}

/* ------------------------------------------------------------------ */
/* SHA-256 (FIPS 180-4) + the bucket-hash batch tiles                 */
/*                                                                     */
/* The state plane's per-record bucket digests (bucket/hashplane.py)   */
/* ride the SAME worker pool as the verify staging: each tile digests  */
/* a run of frames with the GIL released, so a million-entry bucket    */
/* re-hash fans across every core with one Python call.                */
/* ------------------------------------------------------------------ */

typedef struct {
    uint32_t h[8];
    uint64_t len;
    unsigned char buf[64];
    size_t buflen;
} sha256_ctx;

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR32(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void
sha256_init(sha256_ctx *c)
{
    static const uint32_t h0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c->h, h0, sizeof h0);
    c->len = 0;
    c->buflen = 0;
}

static void
sha256_block(sha256_ctx *c, const unsigned char *p)
{
    uint32_t w[64], a, b, d, e, f, g, h, t1, t2, s0, s1, ch, maj, hh;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
    for (i = 16; i < 64; i++) {
        s0 = ROR32(w[i - 15], 7) ^ ROR32(w[i - 15], 18) ^ (w[i - 15] >> 3);
        s1 = ROR32(w[i - 2], 17) ^ ROR32(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    a = c->h[0]; b = c->h[1]; hh = c->h[2]; d = c->h[3];
    e = c->h[4]; f = c->h[5]; g = c->h[6]; h = c->h[7];
    for (i = 0; i < 64; i++) {
        s1 = ROR32(e, 6) ^ ROR32(e, 11) ^ ROR32(e, 25);
        ch = (e & f) ^ (~e & g);
        t1 = h + s1 + ch + K256[i] + w[i];
        s0 = ROR32(a, 2) ^ ROR32(a, 13) ^ ROR32(a, 22);
        maj = (a & b) ^ (a & hh) ^ (b & hh);
        t2 = s0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = hh; hh = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += hh; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void
sha256_update(sha256_ctx *c, const unsigned char *p, size_t n)
{
    c->len += n;
    if (c->buflen) {
        size_t take = 64 - c->buflen;
        if (take > n) take = n;
        memcpy(c->buf + c->buflen, p, take);
        c->buflen += take;
        p += take;
        n -= take;
        if (c->buflen == 64) {
            sha256_block(c, c->buf);
            c->buflen = 0;
        }
    }
    while (n >= 64) {
        sha256_block(c, p);
        p += 64;
        n -= 64;
    }
    if (n) {
        memcpy(c->buf, p, n);
        c->buflen = n;
    }
}

static void
sha256_final(sha256_ctx *c, unsigned char out[32])
{
    uint64_t bitlen = c->len * 8;
    unsigned char pad = 0x80;
    unsigned char z = 0;
    unsigned char lenb[8];
    int i;
    sha256_update(c, &pad, 1);
    while (c->buflen != 56) sha256_update(c, &z, 1);
    for (i = 0; i < 8; i++)
        lenb[i] = (unsigned char)(bitlen >> (56 - 8 * i));
    sha256_update(c, lenb, 8);
    for (i = 0; i < 8; i++) {
        out[4 * i] = (unsigned char)(c->h[i] >> 24);
        out[4 * i + 1] = (unsigned char)(c->h[i] >> 16);
        out[4 * i + 2] = (unsigned char)(c->h[i] >> 8);
        out[4 * i + 3] = (unsigned char)(c->h[i]);
    }
}

/* items are (pointer, length) spans — either borrowed bytes objects
 * (sha256_batch) or frame spans inside one pinned buffer
 * (bucket_hash_frames); out is the n*32 digest array */
typedef struct {
    const uint8_t *p;
    Py_ssize_t len;
    PyObject *o; /* strong ref, NULL for in-buffer spans */
} HSpan;

typedef struct {
    const HSpan *spans;
    size_t n;
    uint8_t *out;     /* n * 32, row i = digest of span i */
    size_t next_tile; /* atomic work counter */
} HJob;

/* bucket frames average a few hundred bytes (~1 us/digest): big tiles
 * keep the atomic counter cold, and fanout pays off quickly */
#define HTILE 128
#define HPAR_MIN 512

static void
run_hash_tiles(void *arg)
{
    HJob *j = arg;
    size_t ntiles = (j->n + HTILE - 1) / HTILE, t;
    while ((t = __atomic_fetch_add(&j->next_tile, 1, __ATOMIC_RELAXED)) <
           ntiles) {
        size_t lo = t * HTILE;
        size_t hi = lo + HTILE;
        size_t i;
        if (hi > j->n)
            hi = j->n;
        for (i = lo; i < hi; i++) {
            sha256_ctx c;
            sha256_init(&c);
            sha256_update(&c, j->spans[i].p, (size_t)j->spans[i].len);
            sha256_final(&c, j->out + 32 * i);
        }
    }
}

static void
run_hash_job(HJob *job, size_t n, int threads)
{
    if (threads == 1 || n < HPAR_MIN || hw_threads() < 2) {
        run_hash_tiles(job);
    } else if (pthread_mutex_trylock(&pool_busy) == 0) {
        run_parallel(run_hash_tiles, job);
        pthread_mutex_unlock(&pool_busy);
    } else {
        /* the pool is mid-job for another caller: run inline */
        run_hash_tiles(job);
    }
}

/* ------------------------------------------------------------------ */
/* Python entry points                                                 */
/* ------------------------------------------------------------------ */

/* bytes ONLY: the pointers are borrowed across the GIL-released compute
 * pass, so the buffers must be immutable — a bytearray could be resized
 * by a concurrent Python thread mid-stage, leaving a dangling pointer.
 * Returns a NEW reference to o (the caller holds it until the pass is
 * done, so a concurrent mutation of the items list cannot free it). */
static PyObject *
borrow_bytes(PyObject *o, const uint8_t **p, Py_ssize_t *len)
{
    if (PyBytes_Check(o)) {
        *p = (const uint8_t *)PyBytes_AS_STRING(o);
        *len = PyBytes_GET_SIZE(o);
        Py_INCREF(o);
        return o;
    }
    PyErr_Format(PyExc_TypeError,
                 "sighash.stage needs immutable bytes items, got %.80s",
                 Py_TYPE(o)->tp_name);
    return NULL;
}

enum { STAGE_HOST, STAGE_RAW, STAGE_ROWS };

/* tuple t's last three slots as an Item, with the GIL held: borrow_bytes'
 * check (a bytes subclass passes) without its reference, since the stage
 * holds t.  -1 with its TypeError at the first slot that is not bytes. */
static int
lane_slots(PyObject *t, Item *it)
{
    Py_ssize_t sz = PyTuple_GET_SIZE(t);
    PyObject *o;
    if (!(o = borrow_bytes(PyTuple_GET_ITEM(t, sz - 3), &it->pk, &it->pk_len)))
        return -1;
    Py_DECREF(o);
    if (!(o = borrow_bytes(PyTuple_GET_ITEM(t, sz - 2), &it->msg,
                           &it->msg_len)))
        return -1;
    Py_DECREF(o);
    if (!(o = borrow_bytes(PyTuple_GET_ITEM(t, sz - 1), &it->sig,
                           &it->sig_len)))
        return -1;
    Py_DECREF(o);
    return 1;
}

/* The lanes the GIL-released pass left (ok[i] == GIL_LANE), staged in lane
 * order once the GIL is back, each row written where the pass would have
 * written it.  -1 with the first lane's TypeError. */
static int
stage_gil_lanes(Job *j, int mode)
{
    size_t i, r, rej = 0, flagged = 0;
    for (i = 0; i < j->n; i++) {
        uint8_t row[DH_ROWS];
        Item it;
        int ok;
        if (j->ok[i] != GIL_LANE)
            continue;
        if (lane_slots(j->tups[i], &it) < 0)
            return -1;
        ok = j->raw ? item_row_raw(&it, row, j->bl, j->nbl)
                    : item_row(&it, row, j->bl, j->nbl);
        j->ok[i] = (uint8_t)ok;
        if (!ok)
            rej++;
        if (mode == STAGE_ROWS) {
            memcpy(j->out + i * DH_ROWS, row, DH_ROWS);
            flagged += row[DH_ROW_FLAG];
        } else {
            for (r = 0; r < j->rowsz; r++)
                j->out[r * j->stride + i] = row[r];
        }
    }
    j->rejects += rej;
    j->flagged += flagged;
    return 0;
}

/* Called through a pointer, so the module imports no symbol of its own
 * for the stamps: a new PLT entry moves every function after it by 16
 * bytes, and at that offset the gate's loops ran ~25 % slower on an
 * Emerald Rapids host (stage_raw over 32,768 lanes, one thread). */
static int (*volatile clock_fn)(clockid_t, struct timespec *) = clock_gettime;

/* CLOCK_MONOTONIC in ns: the clock time.monotonic() reads on Linux, so a
 * stamp divided by 1e9 lies on the span tracer's clock */
static uint64_t
mono_ns(void)
{
    struct timespec ts;
    clock_fn(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ULL + (uint64_t)ts.tv_nsec;
}

enum { N_STAMPS = 5 };

/* stage(items, start, count, out, ok, blacklist, threads=0, stamps) ->
 * rejects
 *
 * items     sequence of (pk, msg, sig) tuples — the LAST three slots are
 *           used, so the verifier's (idx, pk, msg, sig) tuples work too
 * out       writable C-contiguous uint8 buffer of rowsz*stride bytes;
 *           the (rowsz, stride) transposed staging layout (stride >=
 *           count); columns [count, stride) are zeroed (bucket padding).
 *           rowsz = 128 for stage(), DH_ROWS for stage_raw().
 *           stage_rows() takes the (stride, DH_ROWS) item-major layout
 *           instead, and zeroes the records [count, stride).
 * ok        writable uint8 buffer, >= count: per-item gate verdicts
 * blacklist k*32 bytes of sign-masked small-order encodings
 * threads   0 = auto (pool when count >= 2048 and >1 core), 1 = inline
 * stamps    optional writable buffer of 5 uint64: CLOCK_MONOTONIC ns at
 *           [0] entry, [1] just before the GIL is released, [2] just
 *           before it is taken back, [3] just after, [4] exit.  [0, 1) is
 *           the GIL-held prologue (argument parsing, the copy of the item
 *           pointers with one incref a tuple), [1, 2) the compute (which
 *           reads each lane's bytes through its tuple), [2, 3) the wait
 *           for the GIL, [3, 4) the epilogue (the lanes left to the GIL,
 *           the decrefs).  A sixth uint64, where the buffer holds one,
 *           takes the count of those lanes.  Not given: no clock is read.
 *           The staged bytes and the verdicts are the same either way.
 *
 * A lane whose three slots are exact bytes is read with the GIL released;
 * any other lane is staged after the GIL is back, a bytes subclass as
 * bytes, and anything else raises TypeError (out and ok then hold zeros).
 */
static PyObject *
stage_common(PyObject *args, int mode)
{
    PyObject *seq, *fast = NULL;
    Py_ssize_t start, count, stride;
    Py_buffer out = {0}, okb = {0}, bl = {0}, sb = {0};
    int threads = 0;
    PyObject **tups = NULL;
    Py_ssize_t held = 0; /* tups[0, held) hold a reference */
    size_t rejects = 0, flagged = 0, gil_lanes = 0;
    int raw = mode != STAGE_HOST;
    size_t rowsz = raw ? DH_ROWS : 128;
    void (*pass)(void *) = mode == STAGE_ROWS ? run_job_records : run_job_tiles;
    Py_ssize_t j;
    size_t r;
    uint64_t st[N_STAMPS] = {0};

    if (PyTuple_GET_SIZE(args) > 7)
        st[0] = mono_ns();
    if (!PyArg_ParseTuple(args, "Onnw*w*y*|iw*", &seq, &start, &count, &out,
                          &okb, &bl, &threads, &sb))
        return NULL;
    if (sb.obj && sb.len < (Py_ssize_t)sizeof(st)) {
        PyErr_SetString(PyExc_ValueError, "stamps must hold 5 uint64");
        goto fail;
    }
    if (out.len % (Py_ssize_t)rowsz != 0) {
        PyErr_Format(PyExc_ValueError, "out must be %zu*stride bytes",
                     rowsz);
        goto fail;
    }
    stride = out.len / (Py_ssize_t)rowsz;
    if (count < 0 || start < 0 || stride < count || okb.len < count) {
        PyErr_SetString(PyExc_ValueError,
                        "out/ok too small for count (or negative range)");
        goto fail;
    }
    if (bl.len % 32 != 0) {
        PyErr_SetString(PyExc_ValueError, "blacklist must be k*32 bytes");
        goto fail;
    }
    fast = PySequence_Fast(seq, "sighash.stage needs a sequence of tuples");
    if (fast == NULL)
        goto fail;
    if (start + count > PySequence_Fast_GET_SIZE(fast)) {
        PyErr_SetString(PyExc_ValueError, "start+count beyond items");
        goto fail;
    }
    tups = PyMem_Malloc((count ? count : 1) * sizeof(PyObject *));
    if (tups == NULL) {
        PyErr_NoMemory();
        goto fail;
    }
    /* one reference a lane, on its tuple: it keeps the tuple, and so its
     * slots, alive while the pass reads them without the GIL */
    for (held = 0; held < count; held++) {
        PyObject *t = PySequence_Fast_GET_ITEM(fast, start + held);
        if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) < 3) {
            Item it;
            /* an earlier lane's slot error comes first, as when every
             * slot was checked here */
            for (j = 0; j < held; j++)
                if (lane_slots(tups[j], &it) < 0)
                    goto fail;
            PyErr_SetString(PyExc_TypeError,
                            "items must be tuples of >= 3 slots "
                            "(..., pk, msg, sig)");
            goto fail;
        }
        Py_INCREF(t);
        tups[held] = t;
    }

    {
        Job job;
        job.tups = tups;
        job.n = (size_t)count;
        job.out = (uint8_t *)out.buf;
        job.stride = (size_t)stride;
        job.rowsz = rowsz;
        job.raw = raw;
        job.ok = (uint8_t *)okb.buf;
        job.bl = (const uint8_t *)bl.buf;
        job.nbl = (int)(bl.len / 32);
        job.next_tile = 0;
        job.rejects = 0;
        job.flagged = 0;
        job.gil_lanes = 0;
        if (sb.obj)
            st[1] = mono_ns();
        Py_BEGIN_ALLOW_THREADS
        if (threads == 1 || count < PAR_MIN || hw_threads() < 2) {
            pass(&job);
        } else if (pthread_mutex_trylock(&pool_busy) == 0) {
            run_parallel(pass, &job);
            pthread_mutex_unlock(&pool_busy);
        } else {
            /* the pool is mid-job for another caller: run inline */
            pass(&job);
        }
        /* zero the bucket-padding lanes so padded lanes are inert */
        if (stride > count && mode == STAGE_ROWS)
            memset(job.out + (size_t)count * DH_ROWS, 0,
                   (size_t)(stride - count) * DH_ROWS);
        else if (stride > count)
            for (r = 0; r < rowsz; r++)
                memset(job.out + (size_t)r * job.stride + count, 0,
                       (size_t)(stride - count));
        if (sb.obj)
            st[2] = mono_ns();
        Py_END_ALLOW_THREADS
        if (sb.obj)
            st[3] = mono_ns();
        gil_lanes = job.gil_lanes;
        if (gil_lanes && stage_gil_lanes(&job, mode) < 0) {
            /* no lane of a call that raised passes, nor carries bytes */
            memset(out.buf, 0, (size_t)out.len);
            memset(okb.buf, 0, (size_t)count);
            goto fail;
        }
        rejects = job.rejects;
        flagged = job.flagged;
    }

    for (j = 0; j < count; j++)
        Py_DECREF(tups[j]);
    PyMem_Free(tups);
    Py_DECREF(fast);
    PyBuffer_Release(&out);
    PyBuffer_Release(&okb);
    PyBuffer_Release(&bl);
    if (sb.obj) {
        st[4] = mono_ns();
        memcpy(sb.buf, st, sizeof(st));
        if (sb.len >= (Py_ssize_t)(sizeof(st) + sizeof(uint64_t))) {
            uint64_t g = (uint64_t)gil_lanes;
            memcpy((uint8_t *)sb.buf + sizeof(st), &g, sizeof(g));
        }
        PyBuffer_Release(&sb);
    }
    if (mode == STAGE_ROWS)
        return Py_BuildValue("(nn)", (Py_ssize_t)rejects, (Py_ssize_t)flagged);
    return PyLong_FromSize_t(rejects);

fail:
    for (j = 0; j < held; j++)
        Py_DECREF(tups[j]);
    PyMem_Free(tups);
    Py_XDECREF(fast);
    if (out.obj)
        PyBuffer_Release(&out);
    if (okb.obj)
        PyBuffer_Release(&okb);
    if (bl.obj)
        PyBuffer_Release(&bl);
    if (sb.obj)
        PyBuffer_Release(&sb);
    return NULL;
}

static PyObject *
sighash_stage(PyObject *self, PyObject *args)
{
    (void)self;
    return stage_common(args, STAGE_HOST);
}

/* stage_raw(items, start, count, out, ok, blacklist, threads=0, stamps)
 * -> rejects — the DEVICE-HASH staging pass: same strict gate, but the
 * (DH_ROWS, stride) layout carries raw single-block message bytes for
 * the device SHA-512 stage (ops/sha512.py); only multi-block residuals
 * are hashed here.  Host cost per item drops to gate + memcpy. */
static PyObject *
sighash_stage_raw(PyObject *self, PyObject *args)
{
    (void)self;
    return stage_common(args, STAGE_RAW);
}

/* stage_rows(items, start, count, out, ok, blacklist, threads=0, stamps)
 * -> (rejects, flagged) — stage_raw()'s bytes, item-major: lane i's
 * DH_ROWS-byte row at out[i * DH_ROWS:(i + 1) * DH_ROWS], so out is
 * (stride, DH_ROWS); the records [count, stride) are zeroed.  flagged
 * counts the lanes with flag 1, the ones the device hashes: a caller
 * skips the hash stage where it is 0 without reading the flags back. */
static PyObject *
sighash_stage_rows(PyObject *self, PyObject *args)
{
    (void)self;
    return stage_common(args, STAGE_ROWS);
}

/* sodium_verify(fn_addr, items, ok, threads=0) -> None
 *
 * fn_addr   address of libsodium's crypto_sign_verify_detached (the
 *           caller resolves it via ctypes from the SAME library object
 *           the serial path calls — one verifier, two drivers)
 * items     sequence of (pk, msg, sig) bytes tuples (the LAST three
 *           slots are used, like stage())
 * ok        writable uint8 buffer, >= len(items): per-item verdicts
 * threads   0 = auto (pool when n >= 64 and >1 core), 1 = inline
 */
static PyObject *
sighash_sodium_verify(PyObject *self, PyObject *args)
{
    PyObject *seq, *fast = NULL;
    unsigned long long fn_addr = 0;
    Py_buffer okb = {0};
    int threads = 0;
    Item *items = NULL;
    Py_ssize_t n = 0, j;
    (void)self;

    if (!PyArg_ParseTuple(args, "KOw*|i", &fn_addr, &seq, &okb, &threads))
        return NULL;
    if (fn_addr == 0) {
        PyErr_SetString(PyExc_ValueError, "null verify function pointer");
        goto fail;
    }
    fast = PySequence_Fast(seq,
                           "sodium_verify needs a sequence of tuples");
    if (fast == NULL)
        goto fail;
    n = PySequence_Fast_GET_SIZE(fast);
    if (okb.len < n) {
        PyErr_SetString(PyExc_ValueError, "ok buffer too small");
        goto fail;
    }
    items = PyMem_Malloc((n ? n : 1) * sizeof(Item));
    if (items == NULL) {
        PyErr_NoMemory();
        goto fail;
    }
    memset(items, 0, (n ? n : 1) * sizeof(Item));
    for (j = 0; j < n; j++) {
        PyObject *t = PySequence_Fast_GET_ITEM(fast, j);
        Py_ssize_t sz;
        if (!PyTuple_Check(t) || (sz = PyTuple_GET_SIZE(t)) < 3) {
            PyErr_SetString(PyExc_TypeError,
                            "items must be tuples of >= 3 slots "
                            "(..., pk, msg, sig)");
            goto fail;
        }
        items[j].pk_o = borrow_bytes(PyTuple_GET_ITEM(t, sz - 3),
                                     &items[j].pk, &items[j].pk_len);
        items[j].msg_o = borrow_bytes(PyTuple_GET_ITEM(t, sz - 2),
                                      &items[j].msg, &items[j].msg_len);
        items[j].sig_o = borrow_bytes(PyTuple_GET_ITEM(t, sz - 1),
                                      &items[j].sig, &items[j].sig_len);
        if (!items[j].pk_o || !items[j].msg_o || !items[j].sig_o)
            goto fail;
    }

    {
        VJob job;
        job.items = items;
        job.n = (size_t)n;
        job.ok = (uint8_t *)okb.buf;
        job.fn = (sodium_verify_fn)(uintptr_t)fn_addr;
        job.next_tile = 0;
        Py_BEGIN_ALLOW_THREADS
        if (threads == 1 || n < VPAR_MIN || hw_threads() < 2) {
            run_verify_tiles(&job);
        } else if (pthread_mutex_trylock(&pool_busy) == 0) {
            run_parallel(run_verify_tiles, &job);
            pthread_mutex_unlock(&pool_busy);
        } else {
            /* the pool is mid-job for another caller: run inline */
            run_verify_tiles(&job);
        }
        Py_END_ALLOW_THREADS
    }

    for (j = 0; j < n; j++) {
        Py_DECREF(items[j].pk_o);
        Py_DECREF(items[j].msg_o);
        Py_DECREF(items[j].sig_o);
    }
    PyMem_Free(items);
    Py_DECREF(fast);
    PyBuffer_Release(&okb);
    Py_RETURN_NONE;

fail:
    if (items != NULL)
        for (j = 0; j < n; j++) {
            Py_XDECREF(items[j].pk_o);
            Py_XDECREF(items[j].msg_o);
            Py_XDECREF(items[j].sig_o);
        }
    PyMem_Free(items);
    Py_XDECREF(fast);
    if (okb.obj)
        PyBuffer_Release(&okb);
    return NULL;
}

/* sha256_batch(items, out, threads=0) -> None
 *
 * items     sequence of immutable bytes objects
 * out       writable buffer >= len(items)*32: digest i lands at 32*i
 * threads   0 = auto (pool when n >= 512 and >1 core), 1 = inline
 *
 * The per-item digest batch of the state-plane hash pipeline
 * (bucket/hashplane.py): the whole pass runs with the GIL released,
 * tile-fanned over the worker pool. */
static PyObject *
sighash_sha256_batch(PyObject *self, PyObject *args)
{
    PyObject *seq, *fast = NULL;
    Py_buffer outb = {0};
    int threads = 0;
    HSpan *spans = NULL;
    Py_ssize_t n = 0, j;
    (void)self;

    if (!PyArg_ParseTuple(args, "Ow*|i", &seq, &outb, &threads))
        return NULL;
    fast = PySequence_Fast(seq, "sha256_batch needs a sequence of bytes");
    if (fast == NULL)
        goto fail;
    n = PySequence_Fast_GET_SIZE(fast);
    if (outb.len < n * 32) {
        PyErr_SetString(PyExc_ValueError, "out buffer too small (n*32)");
        goto fail;
    }
    spans = PyMem_Malloc((n ? n : 1) * sizeof(HSpan));
    if (spans == NULL) {
        PyErr_NoMemory();
        goto fail;
    }
    memset(spans, 0, (n ? n : 1) * sizeof(HSpan));
    for (j = 0; j < n; j++) {
        spans[j].o = borrow_bytes(PySequence_Fast_GET_ITEM(fast, j),
                                  &spans[j].p, &spans[j].len);
        if (!spans[j].o)
            goto fail;
    }

    {
        HJob job;
        job.spans = spans;
        job.n = (size_t)n;
        job.out = (uint8_t *)outb.buf;
        job.next_tile = 0;
        Py_BEGIN_ALLOW_THREADS
        run_hash_job(&job, (size_t)n, threads);
        Py_END_ALLOW_THREADS
    }

    for (j = 0; j < n; j++)
        Py_DECREF(spans[j].o);
    PyMem_Free(spans);
    Py_DECREF(fast);
    PyBuffer_Release(&outb);
    Py_RETURN_NONE;

fail:
    if (spans != NULL)
        for (j = 0; j < n; j++)
            Py_XDECREF(spans[j].o);
    PyMem_Free(spans);
    Py_XDECREF(fast);
    if (outb.obj)
        PyBuffer_Release(&outb);
    return NULL;
}

/* bucket_hash_frames(buf, threads=0) -> (digest32, count)
 *
 * The one-call host path of the v2 bucket hash: walk the RFC 5531
 * frames of a whole bucket buffer (4-byte big-endian header with the
 * continuation bit, 64 MiB body cap — util/xdrstream.py's bounds),
 * digest every full frame in parallel over the worker pool, then
 * combine the digests in frame order.  Raises ValueError on any
 * malformed or truncated frame.  buf accepts anything read-only
 * buffer-shaped (bytes, memoryview, mmap) and stays pinned for the
 * GIL-released pass. */
static PyObject *
sighash_bucket_hash_frames(PyObject *self, PyObject *args)
{
    Py_buffer buf = {0};
    int threads = 0;
    HSpan *spans = NULL;
    uint8_t *digests = NULL;
    size_t n = 0, cap = 0, off = 0, i;
    const uint8_t *p;
    size_t len;
    unsigned char out[32];
    int bad = 0;
    PyObject *res;
    (void)self;

    if (!PyArg_ParseTuple(args, "y*|i", &buf, &threads))
        return NULL;
    p = (const uint8_t *)buf.buf;
    len = (size_t)buf.len;

    Py_BEGIN_ALLOW_THREADS
    /* pass 1: frame walk (sequential, ~ns per frame) */
    while (off < len) {
        uint32_t flen;
        if (off + 4 > len || !(p[off] & 0x80)) {
            bad = 1;
            break;
        }
        flen = (((uint32_t)p[off] << 24) | ((uint32_t)p[off + 1] << 16) |
                ((uint32_t)p[off + 2] << 8) | p[off + 3]) &
               0x7fffffffu;
        if (flen > (64u << 20) || off + 4 + flen > len) {
            bad = 1;
            break;
        }
        if (n == cap) {
            size_t ncap = cap ? cap * 2 : 1024;
            HSpan *ns = (HSpan *)realloc(spans, ncap * sizeof(HSpan));
            if (!ns) {
                bad = 2;
                break;
            }
            spans = ns;
            cap = ncap;
        }
        spans[n].p = p + off;
        spans[n].len = 4 + flen; /* <= 64 MB + 4: fits the signed field */
        spans[n].o = NULL;
        n++;
        off += 4 + flen;
    }
    if (!bad && n) {
        digests = (uint8_t *)malloc(n * 32);
        if (!digests)
            bad = 2;
    }
    if (!bad) {
        /* pass 2: parallel per-frame digests, pass 3: ordered combine */
        sha256_ctx comb;
        HJob job;
        job.spans = spans;
        job.n = n;
        job.out = digests;
        job.next_tile = 0;
        if (n)
            run_hash_job(&job, n, threads);
        sha256_init(&comb);
        for (i = 0; i < n; i++)
            sha256_update(&comb, digests + 32 * i, 32);
        sha256_final(&comb, out);
    }
    Py_END_ALLOW_THREADS

    free(spans);
    free(digests);
    PyBuffer_Release(&buf);
    if (bad == 2)
        return PyErr_NoMemory();
    if (bad) {
        PyErr_SetString(PyExc_ValueError,
                        "malformed or truncated bucket frame");
        return NULL;
    }
    res = Py_BuildValue("(y#n)", (const char *)out, (Py_ssize_t)32,
                        (Py_ssize_t)n);
    return res;
}

static PyMethodDef methods[] = {
    {"stage", sighash_stage, METH_VARARGS,
     "stage(items, start, count, out, ok, blacklist, threads=0, stamps) -> "
     "rejects: gate + SHA-512(R||A||M) mod L + transposed staging; stamps,"
     " a writable buffer of 5 uint64, takes CLOCK_MONOTONIC ns at entry,"
     " GIL release, GIL request, GIL back and exit, and a sixth uint64 the"
     " count of lanes staged with the GIL held (a slot not exactly bytes)"},
    {"stage_raw", sighash_stage_raw, METH_VARARGS,
     "stage_raw(items, start, count, out, ok, blacklist, threads=0, stamps)"
     " -> rejects: gate-only device-hash staging (raw single-block M bytes;"
     " multi-block residuals hashed here, flag row 0); stamps as stage()'s"},
    {"stage_rows", sighash_stage_rows, METH_VARARGS,
     "stage_rows(items, start, count, out, ok, blacklist, threads=0, stamps)"
     " -> (rejects, flagged): stage_raw()'s rows item-major, a (stride, 160)"
     " out; flagged counts the flag-1 lanes; stamps as stage()'s"},
    {"sodium_verify", sighash_sodium_verify, METH_VARARGS,
     "sodium_verify(fn_addr, items, ok, threads=0): batch libsodium"
     " strict verify over the worker pool, GIL released; verdicts land"
     " in the ok buffer"},
    {"sha256_batch", sighash_sha256_batch, METH_VARARGS,
     "sha256_batch(items, out, threads=0): batch SHA-256 of a bytes"
     " sequence over the worker pool, GIL released; digest i lands at"
     " out[32*i:32*i+32]"},
    {"bucket_hash_frames", sighash_bucket_hash_frames, METH_VARARGS,
     "bucket_hash_frames(buf, threads=0) -> (digest32, count): v2"
     " bucket hash of a framed record buffer — parallel per-frame"
     " digests + ordered combine (bucket/hashplane.py host path)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_sighash", NULL, -1, methods,
};

PyMODINIT_FUNC
PyInit__sighash(void)
{
    return PyModule_Create(&moduledef);
}
