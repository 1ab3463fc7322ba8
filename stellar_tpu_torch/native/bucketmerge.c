/* Native bucket-merge engine for stellar-tpu.
 *
 * The reference runs bucket hashing/merging on C++ worker threads
 * (src/bucket/Bucket.cpp Bucket::merge, src/main/ApplicationImpl.cpp:120);
 * this is the equivalent native hot path for the TPU-native framework:
 * a streaming 2-way merge of sorted XDR bucket files with shadow elision
 * and an incremental SHA-256 over the output frames, callable from Python
 * via ctypes (which releases the GIL for the whole merge, so worker-pool
 * merges never stall the main crank).
 *
 * File format (util/xdrstream.py): each record is a 4-byte big-endian
 * length with the high bit set, followed by the XDR body.  Record =
 * BucketEntry { u32 disc (0=LIVEENTRY,1=DEADENTRY); LedgerEntry | LedgerKey }.
 * Entry identity = (entry type, LedgerKey XDR bytes); the key fields are
 * the leading fields of each entry body, so identity extraction is a
 * prefix parse only (xdr/entries.py layouts).
 *
 * Semantics mirror bucket/bucket.py exactly (differential test:
 * tests/test_native_merge.py): new wins on identity collision, shadowed
 * identities are elided, DEADENTRYs are dropped when keep_dead == 0.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* SHA-256 (implemented from FIPS 180-4)                               */
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

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_init(sha256_ctx *c) {
    static const uint32_t h0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c->h, h0, sizeof h0);
    c->len = 0;
    c->buflen = 0;
}

static void sha256_block(sha256_ctx *c, const unsigned char *p) {
    uint32_t w[64], a, b, d, e, f, g, h, t1, t2, s0, s1, ch, maj, hh;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
    for (i = 16; i < 64; i++) {
        s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
        s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    a = c->h[0]; b = c->h[1]; hh = c->h[2]; d = c->h[3];
    e = c->h[4]; f = c->h[5]; g = c->h[6]; h = c->h[7];
    for (i = 0; i < 64; i++) {
        s1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
        ch = (e & f) ^ (~e & g);
        t1 = h + s1 + ch + K256[i] + w[i];
        s0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
        maj = (a & b) ^ (a & hh) ^ (b & hh);
        t2 = s0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = hh; hh = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += hh; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void sha256_update(sha256_ctx *c, const unsigned char *p, size_t n) {
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

static void sha256_final(sha256_ctx *c, unsigned char out[32]) {
    uint64_t bitlen = c->len * 8;
    unsigned char pad = 0x80;
    unsigned char z = 0;
    unsigned char lenb[8];
    int i;
    sha256_update(c, &pad, 1);
    while (c->buflen != 56) sha256_update(c, &z, 1);
    for (i = 0; i < 8; i++) lenb[i] = (unsigned char)(bitlen >> (56 - 8 * i));
    sha256_update(c, lenb, 8);
    for (i = 0; i < 8; i++) {
        out[4 * i] = (unsigned char)(c->h[i] >> 24);
        out[4 * i + 1] = (unsigned char)(c->h[i] >> 16);
        out[4 * i + 2] = (unsigned char)(c->h[i] >> 8);
        out[4 * i + 3] = (unsigned char)(c->h[i]);
    }
}

/* ------------------------------------------------------------------ */
/* XDR record streams                                                  */
/* ------------------------------------------------------------------ */

typedef struct {
    FILE *f;
    unsigned char *body;
    size_t cap;
    size_t len;     /* current record body length */
    int have;       /* a record is loaded */
    /* identity of the loaded record */
    uint32_t etype; /* ledger entry type */
    const unsigned char *key;
    size_t keylen;
    int is_dead;
} stream;

static uint32_t be32(const unsigned char *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}

/* length of an Asset union at p (bounds-checked); 0 on parse error */
static size_t asset_len(const unsigned char *p, size_t avail) {
    uint32_t t;
    if (avail < 4) return 0;
    t = be32(p);
    if (t == 0) return 4;            /* native */
    if (t == 1) return 4 + 4 + 36;   /* alphanum4: code[4] + issuer */
    if (t == 2) return 4 + 12 + 36;  /* alphanum12 */
    return 0;
}

/* identity key length for entry type at p (key bytes start at p) */
static size_t key_len(uint32_t etype, const unsigned char *p, size_t avail) {
    size_t al;
    switch (etype) {
    case 0: /* ACCOUNT: PublicKey (4+32) */
        return avail >= 36 ? 36 : 0;
    case 1: /* TRUSTLINE: accountID + asset */
        if (avail < 36) return 0;
        al = asset_len(p + 36, avail - 36);
        return al ? 36 + al : 0;
    case 2: /* OFFER: sellerID + offerID(u64) */
        return avail >= 44 ? 44 : 0;
    default:
        return 0;
    }
}

/* parse identity of the loaded BucketEntry body; 0 on success */
static int parse_identity(stream *s) {
    const unsigned char *b = s->body;
    size_t n = s->len;
    uint32_t disc;
    if (n < 8) return -1;
    disc = be32(b);
    if (disc == 0) { /* LIVEENTRY: u32 lastModified, u32 entry type, key... */
        if (n < 12) return -1;
        s->is_dead = 0;
        s->etype = be32(b + 8);
        s->key = b + 12;
        s->keylen = key_len(s->etype, b + 12, n - 12);
    } else if (disc == 1) { /* DEADENTRY: LedgerKey = u32 type, key... */
        s->is_dead = 1;
        s->etype = be32(b + 4);
        s->key = b + 8;
        s->keylen = key_len(s->etype, b + 8, n - 8);
    } else {
        return -1;
    }
    return s->keylen ? 0 : -1;
}

/* read next record; 1 = got one, 0 = eof, -1 = error */
static int stream_next(stream *s) {
    unsigned char hdr[4];
    uint32_t sz;
    size_t got;
    s->have = 0;
    if (!s->f) return 0;
    got = fread(hdr, 1, 4, s->f);
    if (got == 0) return 0;
    if (got != 4) return -1;
    sz = be32(hdr) & 0x7fffffffu;
    if (sz > (64u << 20)) return -1;
    if (sz > s->cap) {
        unsigned char *nb = (unsigned char *)realloc(s->body, sz);
        if (!nb) return -1;
        s->body = nb;
        s->cap = sz;
    }
    if (fread(s->body, 1, sz, s->f) != sz) return -1;
    s->len = sz;
    if (parse_identity(s) != 0) return -1;
    s->have = 1;
    return 1;
}

static int stream_open(stream *s, const char *path) {
    memset(s, 0, sizeof *s);
    if (path && path[0]) {
        s->f = fopen(path, "rb");
        if (!s->f) return -1;
    }
    return stream_next(s) < 0 ? -1 : 0;
}

static void stream_close(stream *s) {
    if (s->f) fclose(s->f);
    free(s->body);
}

/* identity compare: entry type, then key bytes lexicographic
 * (shorter-is-less on equal prefix) — matches bucket.py entry_identity */
static int ident_cmp(const stream *a, const stream *b) {
    size_t n;
    int r;
    if (a->etype != b->etype) return a->etype < b->etype ? -1 : 1;
    n = a->keylen < b->keylen ? a->keylen : b->keylen;
    r = memcmp(a->key, b->key, n);
    if (r) return r < 0 ? -1 : 1;
    if (a->keylen != b->keylen) return a->keylen < b->keylen ? -1 : 1;
    return 0;
}

/* ------------------------------------------------------------------ */
/* the merge                                                           */
/* ------------------------------------------------------------------ */

#define MAX_SHADOWS 32

typedef struct {
    FILE *f;
    sha256_ctx sha;
    long long count;
    int keep_dead;
    stream shadows[MAX_SHADOWS];
    int n_shadows;
    /* one-entry dedup window: adjacent same-identity entries collapse,
     * last wins — mirrors bucket.py _write_merged's buffered put (and the
     * reference BucketOutputIterator), keeping both paths bit-identical
     * even for inputs that contain duplicate identities */
    unsigned char *pend;
    size_t pend_cap;
    size_t pend_len;
    uint32_t pend_etype;
    unsigned char pend_key[96]; /* max identity: trustline 36+52 = 88 */
    size_t pend_keylen;
    int pend_have;
    int v2; /* per-record-digest bucket hash (see emit) */
} writer;

/* write one framed record + hash it.
 *
 * v1 hash: incremental SHA-256 over the raw frame stream as written.
 * v2 hash (bucket/hashplane.py): SHA-256 over the CONCAT OF
 * PER-RECORD DIGESTS, each digest = SHA-256(4-byte header ‖ body) of one
 * full frame.  The per-record digests are what the batched device/pooled
 * host kernels compute in parallel; this sequential combine touches 32
 * bytes per record (~3% of the stream), so the hash cost parallelizes.
 * Hashes are framework-local (bucket.py header note), so the scheme is
 * free to differ from the reference's stream hash — all producers and
 * verifiers changed together. */
static int emit(writer *w, const unsigned char *body, size_t len) {
    unsigned char hdr[4];
    uint32_t framed = (uint32_t)len | 0x80000000u;
    hdr[0] = (unsigned char)(framed >> 24);
    hdr[1] = (unsigned char)(framed >> 16);
    hdr[2] = (unsigned char)(framed >> 8);
    hdr[3] = (unsigned char)framed;
    if (fwrite(hdr, 1, 4, w->f) != 4) return -1;
    if (fwrite(body, 1, len, w->f) != len) return -1;
    if (w->v2) {
        sha256_ctx rec;
        unsigned char digest[32];
        sha256_init(&rec);
        sha256_update(&rec, hdr, 4);
        sha256_update(&rec, body, len);
        sha256_final(&rec, digest);
        sha256_update(&w->sha, digest, 32);
    } else {
        sha256_update(&w->sha, hdr, 4);
        sha256_update(&w->sha, body, len);
    }
    w->count++;
    return 0;
}

static int flush_pending(writer *w) {
    if (!w->pend_have) return 0;
    w->pend_have = 0;
    return emit(w, w->pend, w->pend_len);
}

/* stash the record as the pending entry (s->body is reused by the next
 * stream_next, so copy) */
static int buffer_rec(writer *w, const stream *s) {
    if (s->keylen > sizeof w->pend_key) return -1;
    if (s->len > w->pend_cap) {
        unsigned char *nb = (unsigned char *)realloc(w->pend, s->len);
        if (!nb) return -1;
        w->pend = nb;
        w->pend_cap = s->len;
    }
    memcpy(w->pend, s->body, s->len);
    w->pend_len = s->len;
    w->pend_etype = s->etype;
    memcpy(w->pend_key, s->key, s->keylen);
    w->pend_keylen = s->keylen;
    w->pend_have = 1;
    return 0;
}

/* 1 if the candidate identity appears in any shadow stream */
static int shadowed(writer *w, const stream *cand) {
    int i, r;
    for (i = 0; i < w->n_shadows; i++) {
        stream *sh = &w->shadows[i];
        while (sh->have && ident_cmp(sh, cand) < 0)
            if (stream_next(sh) < 0) return -1;
        if (sh->have && ident_cmp(sh, cand) == 0) return 1;
    }
    return 0;
}

static int put(writer *w, const stream *s) {
    int sh;
    if (s->is_dead && !w->keep_dead) return 0;
    sh = shadowed(w, s);
    if (sh < 0) return -1;
    if (sh) return 0;
    if (w->pend_have && w->pend_etype == s->etype &&
        w->pend_keylen == s->keylen &&
        memcmp(w->pend_key, s->key, s->keylen) == 0) {
        /* same identity as the buffered entry: last wins */
        w->pend_have = 0;
        return buffer_rec(w, s);
    }
    if (flush_pending(w) != 0) return -1;
    return buffer_rec(w, s);
}

static int merge_impl(const char *old_path, const char *new_path,
                      const char **shadow_paths, int n_shadows,
                      int keep_dead, const char *out_path,
                      unsigned char out_hash[32], long long *out_count,
                      int v2) {
    stream so, sn;
    writer w;
    int i, rc = -1;
    memset(&w, 0, sizeof w);
    w.v2 = v2;
    if (n_shadows > MAX_SHADOWS) return -1;
    if (stream_open(&so, old_path) != 0) return -1;
    if (stream_open(&sn, new_path) != 0) {
        stream_close(&so);
        return -1;
    }
    w.f = fopen(out_path, "wb");
    if (!w.f) {
        stream_close(&so);
        stream_close(&sn);
        return -1;
    }
    sha256_init(&w.sha);
    w.keep_dead = keep_dead;
    w.n_shadows = n_shadows;
    for (i = 0; i < n_shadows; i++)
        if (stream_open(&w.shadows[i], shadow_paths[i]) != 0) {
            w.n_shadows = i;
            goto done;
        }

    while (so.have || sn.have) {
        int c;
        if (!sn.have)
            c = -1;
        else if (!so.have)
            c = 1;
        else
            c = ident_cmp(&so, &sn);
        if (c < 0) { /* old smaller: take old */
            if (put(&w, &so) != 0) goto done;
            if (stream_next(&so) < 0) goto done;
        } else if (c > 0) { /* new smaller: take new */
            if (put(&w, &sn) != 0) goto done;
            if (stream_next(&sn) < 0) goto done;
        } else { /* same identity: new wins */
            if (put(&w, &sn) != 0) goto done;
            if (stream_next(&so) < 0) goto done;
            if (stream_next(&sn) < 0) goto done;
        }
    }
    if (flush_pending(&w) != 0) goto done;
    sha256_final(&w.sha, out_hash);
    *out_count = w.count;
    rc = 0;
done:
    stream_close(&so);
    stream_close(&sn);
    for (i = 0; i < w.n_shadows; i++) stream_close(&w.shadows[i]);
    free(w.pend);
    if (w.f) fclose(w.f);
    if (rc != 0) remove(out_path);
    return rc;
}

int bucket_merge(const char *old_path, const char *new_path,
                 const char **shadow_paths, int n_shadows, int keep_dead,
                 const char *out_path, unsigned char out_hash[32],
                 long long *out_count) {
    return merge_impl(old_path, new_path, shadow_paths, n_shadows,
                      keep_dead, out_path, out_hash, out_count, 0);
}

/* v2 merge: identical record stream, per-record-digest bucket hash (the
 * symbol is NEW so a stale prebuilt .so simply lacks it and the loader
 * falls back to the Python merge — never a silent v1/v2 hash mismatch) */
int bucket_merge_v2(const char *old_path, const char *new_path,
                    const char **shadow_paths, int n_shadows, int keep_dead,
                    const char *out_path, unsigned char out_hash[32],
                    long long *out_count) {
    return merge_impl(old_path, new_path, shadow_paths, n_shadows,
                      keep_dead, out_path, out_hash, out_count, 1);
}

/* streaming SHA-256 of a whole file (raw byte-stream hash; kept for the
 * pre-v2 differential pins in tests/test_native_merge.py) */
int sha256_file(const char *path, unsigned char out[32]) {
    unsigned char buf[1 << 16];
    sha256_ctx c;
    size_t n;
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    sha256_init(&c);
    while ((n = fread(buf, 1, sizeof buf, f)) > 0) sha256_update(&c, buf, n);
    fclose(f);
    sha256_final(&c, out);
    return 0;
}

/* v2 re-hash of an existing bucket file: walk the RFC 5531 frames
 * (4-byte big-endian header, continuation bit set, 64 MiB body cap —
 * the exact bounds util/xdrstream.py and stream_next enforce), digest
 * each full frame, combine the digests.  Returns -1 on open failure or
 * any malformed/truncated frame (the caller treats that as corrupt). */
int bucket_hash_v2_file(const char *path, unsigned char out[32],
                        long long *out_count) {
    unsigned char hdr[4];
    unsigned char *body = NULL;
    size_t cap = 0;
    long long count = 0;
    sha256_ctx comb;
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    sha256_init(&comb);
    for (;;) {
        size_t got = fread(hdr, 1, 4, f);
        uint32_t len;
        sha256_ctx rec;
        unsigned char digest[32];
        if (got == 0) break; /* clean EOF at a frame boundary */
        if (got != 4 || !(hdr[0] & 0x80)) goto bad;
        len = (((uint32_t)hdr[0] << 24) | ((uint32_t)hdr[1] << 16) |
               ((uint32_t)hdr[2] << 8) | hdr[3]) &
              0x7fffffffu;
        if (len > (64u << 20)) goto bad;
        if (len > cap) {
            unsigned char *nb = (unsigned char *)realloc(body, len);
            if (!nb) goto bad;
            body = nb;
            cap = len;
        }
        if (len && fread(body, 1, len, f) != len) goto bad;
        sha256_init(&rec);
        sha256_update(&rec, hdr, 4);
        sha256_update(&rec, body, len);
        sha256_final(&rec, digest);
        sha256_update(&comb, digest, 32);
        count++;
    }
    free(body);
    fclose(f);
    sha256_final(&comb, out);
    *out_count = count;
    return 0;
bad:
    free(body);
    fclose(f);
    return -1;
}
