"""Batched single-block SHA-512(R‖A‖M) mod L: the device-hash stage of the
verify plane, as a plain PyTorch version.

The kernel that runs on the card is ``csrc/sha512_h.cu`` (wrapper
``ops/sha512_cuda.py``); this module is its plain version and the layout
it reads, a copy of the JAX package's ``ops/sha512.py`` semantics.  With
``BatchVerifier(device_hash=True)`` the host keeps only the strict gate:
single-block items (preimage R‖A‖M of at most 111 bytes, M at most
``MAX_DEVICE_MSG`` = 47 bytes — the dominant 96-byte tx-hash class) upload
their raw message bytes and the card computes h; longer messages are
hashed by the C host stage (``native/sighash.c`` ``stage_rows``) and merge
at the same kernel through the flag row.

The host stage writes a chunk item-major, an (N, ``DH_ROWS``) buffer with
one lane's rows a row of it (``stage_rows``; ``stage_raw`` writes the same
bytes transposed), and the card turns it into the layout below
(``csrc/sha512_h.cu`` ``dh_rows_to_cols_kernel``; ``cols_from_rows`` is its
plain version).

Device-hash packed staging layout (uint8, ``DH_ROWS`` = 160 rows/lane):

    rows   0:32   A          (pubkey bytes)
    rows  32:64   R          (signature first half)
    rows  64:96   s          (signature second half)
    rows  96:144  M          (raw message, mlen <= 47, zero-padded)
                  — or h, host-computed, in rows 96:128 when flag == 0
    row  144      mlen       (0..47; 0 when flag == 0)
    row  145      flag       (1 = single-block, hash on the device;
                              0 = h precomputed on the host)
    rows 146:160  zero

Representation: every 32-bit word (a SHA-512 word is a hi/lo pair of
them) is held in an int64 tensor with its value in [0, 2^32) and masked
after each add or shift, so no operation relies on integer wrap-around.
The mod-L reduction is the JAX package's branch-free fold at 2^252 on
radix-2^13 limbs, with floor division for the carries.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import ref25519 as ref

L = ref.L
C = L - (1 << 252)  # 125-bit tail of L

MAX_DEVICE_MSG = 47  # single-block: 64 + mlen <= 111
DH_ROWS = 160
ROW_M = 96
ROW_MLEN = 144
ROW_FLAG = 145

L_BYTES = np.frombuffer(L.to_bytes(32, "little"), dtype=np.uint8)

_M32 = 0xFFFFFFFF

# FIPS 180-4 round constants / IV
_K512 = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_H512_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


# ---------------------------------------------------------------------------
# 64-bit words as (hi, lo) pairs of 32-bit values in int64 tensors
# ---------------------------------------------------------------------------


def _add(*words):
    """Sum mod 2^64 of (hi, lo) pairs; a pair may hold Python ints."""
    lo = sum(w[1] for w in words)
    hi = sum(w[0] for w in words) + (lo >> 32)
    return hi & _M32, lo & _M32


def _rotr(w, n: int):
    h, l = w
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (
        ((h >> n) | (l << (32 - n))) & _M32,
        ((l >> n) | (h << (32 - n))) & _M32,
    )


def _shr(w, n: int):
    """64-bit logical right shift by 0 < n < 32."""
    h, l = w
    return h >> n, ((l >> n) | (h << (32 - n))) & _M32


def _xor(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _split(v: int):
    return v >> 32, v & _M32


# ---------------------------------------------------------------------------
# the compression function (one block)
# ---------------------------------------------------------------------------


def _compress_block(block_rows):
    """One SHA-512 compression from the IV over a padded 128-byte block.

    block_rows — 128 int64 (N,) byte rows.  Returns the 8 digest words
    as (hi, lo) pairs."""
    w = []
    for t in range(16):
        b = block_rows[8 * t : 8 * t + 8]
        w.append((
            (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3],
            (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7],
        ))
    st = [_split(v) for v in _H512_IV]
    for t in range(80):
        if t >= 16:
            s0 = _xor(_rotr(w[t - 15], 1), _rotr(w[t - 15], 8), _shr(w[t - 15], 7))
            s1 = _xor(_rotr(w[t - 2], 19), _rotr(w[t - 2], 61), _shr(w[t - 2], 6))
            w.append(_add(w[t - 16], s0, w[t - 7], s1))
        a, b, c, d, e, f, g, h = st
        s1 = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = tuple((e[i] & f[i]) ^ ((e[i] ^ _M32) & g[i]) for i in range(2))
        t1 = _add(h, s1, ch, _split(_K512[t]), w[t])
        s0 = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        mj = tuple((a[i] & b[i]) ^ (a[i] & c[i]) ^ (b[i] & c[i]) for i in range(2))
        st = [_add(t1, s0, mj), a, b, c, _add(d, t1), e, f, g]
    return [_add(st[i], _split(_H512_IV[i])) for i in range(8)]


def _digest_byte_rows(words):
    """8 digest words -> 64 byte rows in SHA-512 output order (each word
    big-endian): the byte string hashlib would give."""
    rows = []
    for hi, lo in words:
        for half in (hi, lo):
            rows += [(half >> 24) & 0xFF, (half >> 16) & 0xFF, (half >> 8) & 0xFF, half & 0xFF]
    return rows


# ---------------------------------------------------------------------------
# mod L — branch-free fold at the 2^252 boundary, radix-2^13 limbs
# ---------------------------------------------------------------------------

RADIX = 13
MASK = (1 << RADIX) - 1


def _int_to_limb_list(v: int, n: int):
    out = []
    for _ in range(n):
        out.append(v & MASK)
        v >>= RADIX
    assert v == 0
    return out


# fold compensators: K >= max possible B*c at that fold, as a multiple of
# L, so A + K - B*c stays nonnegative (bounds in _mod_l_rows)
_C_LIMBS = _int_to_limb_list(C, 10)
_K1_LIMBS = _int_to_limb_list(((1 << 385) // L + 1) * L, 30)
_K2_LIMBS = _int_to_limb_list(((1 << 260) // L + 1) * L, 21)
_L_LIMBS = _int_to_limb_list(L, 20)


def _norm_limbs(raw, out_len: int):
    """Bottom-up floor carry: limbs land in [0, 2^13) with any residue in
    the top limb (nonnegative: every fold adds a multiple of L that
    covers what it subtracts)."""
    out = []
    carry = None
    for i in range(out_len):
        v = raw[i] if i < len(raw) else torch.zeros_like(raw[0])
        if carry is not None:
            v = v + carry
        if i == out_len - 1:
            out.append(v)
        else:
            carry = torch.div(v, 1 << RADIX, rounding_mode="floor")
            out.append(v - (carry << RADIX))
    return out


def _split_252(x):
    """Normalized limbs -> (A, B) with x = A + B * 2^252; bit 252 is limb
    19 bit 5 (19 * 13 = 247)."""
    a = list(x[:19]) + [x[19] & 0x1F]
    b = []
    for j in range(len(x) - 19):
        lo = x[19 + j] >> 5
        if 20 + j < len(x):
            lo = lo | ((x[20 + j] & 0x1F) << 8)
        b.append(lo)
    return a, b


def _mul_c(b):
    """Schoolbook b * c over limb lists."""
    cols = [None] * (len(b) + len(_C_LIMBS) - 1)
    for j, cj in enumerate(_C_LIMBS):
        if cj == 0:
            continue
        for i in range(len(b)):
            term = b[i] * cj
            cols[i + j] = term if cols[i + j] is None else cols[i + j] + term
    zero = torch.zeros_like(b[0])
    return [c if c is not None else zero for c in cols]


def _fold_252(x, k_limbs, out_len: int):
    """x = A + B*2^252 ≡ A + K − B*c (mod L), K a multiple of L ≥ B*c."""
    a, b = _split_252(x)
    t = _mul_c(b)
    zero = torch.zeros_like(x[0])
    raw = []
    for i in range(max(len(a), len(t), len(k_limbs))):
        v = a[i] if i < len(a) else zero
        if i < len(k_limbs) and k_limbs[i]:
            v = v + k_limbs[i]
        if i < len(t):
            v = v - t[i]
        raw.append(v)
    return _norm_limbs(raw, out_len)


def _limbs_from_le_byte_rows(rows, nlimbs: int):
    """Little-endian byte rows -> radix-2^13 limb rows."""
    limbs = []
    for k in range(nlimbs):
        j0, r0 = divmod(RADIX * k, 8)
        if j0 >= len(rows):
            limbs.append(torch.zeros_like(rows[0]))
            continue
        acc = rows[j0] >> r0
        width = 8 - r0
        j = j0 + 1
        while width < RADIX and j < len(rows):
            acc = acc | (rows[j] << width)
            width += 8
            j += 1
        limbs.append(acc & MASK)
    return limbs


def _le_byte_rows_from_limbs(limbs, nbytes: int):
    """Canonical [0, 2^13) limb rows -> little-endian byte rows."""
    out = []
    for j in range(nbytes):
        k0, r0 = divmod(8 * j, RADIX)
        acc = limbs[k0] >> r0
        width = RADIX - r0
        if width < 8 and k0 + 1 < len(limbs):
            acc = acc | (limbs[k0 + 1] << width)
        out.append(acc & 0xFF)
    return out


def _limbs_ge(x, const_limbs):
    """x >= const over normalized limbs, compared from the top."""
    eq = torch.ones_like(x[0], dtype=torch.bool)
    gt = torch.zeros_like(x[0], dtype=torch.bool)
    for i in range(len(x) - 1, -1, -1):
        ci = const_limbs[i] if i < len(const_limbs) else 0
        gt = gt | (eq & (x[i] > ci))
        eq = eq & (x[i] == ci)
    return gt | eq


def _mod_l_rows(digest_rows):
    """64 little-endian digest byte rows -> 32 byte rows of the value mod L.

    Bounds (x the 512-bit digest value):
      fold 1: B1 < 2^260, B1*c < 2^385, K1 < 2^386 -> y1 in [0, 2^387)
      fold 2: B2 < 2^135, B2*c < 2^260, K2 < 2^261 -> y2 in [0, 2^262)
      fold 3: B3 < 2^10, B3*c < L, K3 = L         -> y3 in [0, 2^254)
      fold 4: B4 < 4, B4*c < L, K4 = L            -> y4 in [0, 2L)
      then one conditional subtract of L -> [0, L).
    """
    x = _limbs_from_le_byte_rows(digest_rows, 40)
    y = _fold_252(x, _K1_LIMBS, 30)
    y = _fold_252(y, _K2_LIMBS, 21)
    y = _fold_252(y, _L_LIMBS, 20)
    y = _fold_252(y, _L_LIMBS, 20)
    ge = _limbs_ge(y, _L_LIMBS).to(y[0].dtype)
    raw = [y[i] - ge * _L_LIMBS[i] for i in range(20)]
    return _le_byte_rows_from_limbs(_norm_limbs(raw, 20), 32)


# ---------------------------------------------------------------------------
# the stage over the packed device-hash layout
# ---------------------------------------------------------------------------


def _build_block_rows(rows):
    """160 int64 packed rows -> the 128 rows of the padded block of
    SHA-512(R ‖ A ‖ M): byte 64+j is M[j] below mlen, 0x80 at mlen, 0
    above; the bit-length field (64 + mlen) * 8 fills the last two bytes."""
    mlen = rows[ROW_MLEN]
    block = [rows[32 + j] for j in range(32)]  # R first
    block += [rows[j] for j in range(32)]  # then A
    for j in range(MAX_DEVICE_MSG + 1):  # bytes 64..111
        pad = torch.where(mlen == j, 0x80, 0)
        block.append(torch.where(mlen > j, rows[ROW_M + j], pad))
    zero = torch.zeros_like(mlen)
    block += [zero] * 14  # bytes 112..125
    total_bits = (mlen + 64) * 8
    block += [total_bits >> 8, total_bits & 0xFF]
    return block


def _h_rows(rows):
    """160 int64 packed rows -> (32, N) int64 h rows: SHA-512 mod L for
    flag != 0 lanes, the uploaded host h for flag == 0 lanes."""
    digest = _digest_byte_rows(_compress_block(_build_block_rows(rows)))
    h_dev = torch.stack(_mod_l_rows(digest))
    host = (rows[ROW_FLAG] == 0)[None, :]
    return torch.where(host, torch.stack(rows[96:128]), h_dev)


# runs of the plain version, on any device — a run that must go through
# the CUDA kernel reads this to show that it did not come here
plain_calls = 0
_plain_lock = threading.Lock()


def h_rows_from_packed(p):
    """(160, N) uint8 device-hash staging -> (32, N) int32 h byte rows
    (device-hashed or host-merged per the flag row).  A chunk with no
    flag=1 lane passes rows 96:128 through without running the rounds."""
    global plain_calls
    with _plain_lock:
        plain_calls += 1
    if not bool((p[ROW_FLAG] != 0).any()):
        return p[96:128].to(torch.int32)
    rows = list(p.to(torch.int64).unbind(0))
    return _h_rows(rows).to(torch.int32)


def cols_from_rows(x):
    """(N, 160) uint8 item-major device-hash rows -> a new (160, N) uint8
    staging chunk: the plain version of ``dh_rows_to_cols_kernel``."""
    return x.view(-1, DH_ROWS).t().contiguous()


def reduce_digest(digest: bytes) -> bytes:
    """64 LE digest bytes -> 32 LE bytes of the value mod L (bigints)."""
    return (int.from_bytes(digest, "little") % L).to_bytes(32, "little")
