"""Batched multi-block SHA-256 over padded columns: the bucket-hash plane's
kernel, as a plain PyTorch version, and its host packer.

The kernel that runs on the card is ``csrc/sha256_frames.cu`` (wrapper
``ops/sha256_cuda.py``); this module is its plain version and the layout
it reads, a copy of the JAX package's ``ops/sha256.py`` semantics.  Every
``Bucket.fresh``, level-spill merge, catchup re-hash and selfcheck audit
digests each record frame of a bucket independently
(``bucket/hashplane.py``): an embarrassingly parallel batch of short
messages.

Layout: the host pads each message per FIPS 180-4 (0x80 terminator,
8-byte big-endian bit length) into a ``(max_blocks * 64, N)`` uint8 column
layout plus an ``(N,)`` int32 block count; lane j's digest chains its
first ``nblocks[j]`` blocks (block 0 always; a block b ≥ 1 only while
b < nblocks[j]).  Digests come back as (32, N) byte rows, big-endian
within each word: the byte string hashlib gives.

Representation: each 32-bit word is held in an int64 tensor with its
value in [0, 2^32), masked after every add and shift, so no operation
relies on integer wrap-around.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_M32 = 0xFFFFFFFF

# FIPS 180-4 round constants / IV
_K256 = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B,
    0x59F111F1, 0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01,
    0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7,
    0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152,
    0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819,
    0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116, 0x1E376C08,
    0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F,
    0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_H256_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_block(state, block_rows):
    """One SHA-256 compression: ``state`` is 8 int64 (N,) chaining words,
    ``block_rows`` 64 int64 (N,) byte rows of one padded block.  Returns
    the new chaining value (feed-forward included)."""
    w = [
        (block_rows[4 * t] << 24) | (block_rows[4 * t + 1] << 16)
        | (block_rows[4 * t + 2] << 8) | block_rows[4 * t + 3]
        for t in range(16)
    ]
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = h + S1 + ch + _K256[t] + w[t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        mj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + S0 + mj) & _M32
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


# runs of the plain version, on any device — a run that must go through
# the CUDA kernel reads this to show that it did not come here
plain_calls = 0
_plain_lock = threading.Lock()


def sha256_rows_from_packed(p, nblocks):
    """(max_blocks * 64, N) uint8 padded columns + (N,) int32 block counts
    -> (32, N) int32 digest byte rows (big-endian word order)."""
    global plain_calls
    with _plain_lock:
        plain_calls += 1
    max_blocks = p.shape[0] // 64
    nblocks = nblocks.to(device=p.device, dtype=torch.int64)
    st = [torch.full((p.shape[1],), v, dtype=torch.int64, device=p.device) for v in _H256_IV]
    for blk in range(max_blocks):
        rows = list(p[64 * blk : 64 * (blk + 1)].to(torch.int64).unbind(0))
        new = _compress_block(st, rows)
        if blk == 0:
            st = new  # every lane takes its first block
        else:
            live = nblocks > blk
            st = [torch.where(live, x, y) for x, y in zip(new, st)]
    out = []
    for word in st:
        out += [(word >> 24) & 0xFF, (word >> 16) & 0xFF, (word >> 8) & 0xFF, word & 0xFF]
    return torch.stack(out).to(torch.int32)


# ---------------------------------------------------------------------------
# host-side staging (numpy) — FIPS 180-4 padding into fixed shapes
# ---------------------------------------------------------------------------


def blocks_for(length: int) -> int:
    """Padded block count of an ``length``-byte message (terminator byte
    + 8-byte length field force a new block past length % 64 == 55)."""
    return (length + 8) // 64 + 1


def pack_frames(items, max_blocks: int = 0):
    """Pad each item per FIPS 180-4 into the fixed (max_blocks * 64, N)
    uint8 column layout + (N,) int32 block counts the kernels consume.
    ``max_blocks`` > 0 pins the row count; it must cover the longest item.

    Vectorised (the same arrays as the JAX package's per-item loop): lanes
    are filled lane-major, one numpy copy per distinct item length, then
    transposed into the column layout."""
    n = len(items)
    lengths = np.fromiter(map(len, items), dtype=np.int64, count=n)
    counts = ((lengths + 8) // 64 + 1).astype(np.int32)
    need = int(counts.max()) if n else 1
    if max_blocks:
        if need > max_blocks:
            raise ValueError(f"item needs {need} blocks > pinned max {max_blocks}")
        need = max_blocks
    lanes = np.zeros((max(n, 1), need * 64), dtype=np.uint8)
    if n:
        order = np.argsort(lengths, kind="stable")
        by_len = lengths[order]
        starts = np.flatnonzero(np.r_[True, by_len[1:] != by_len[:-1]])
        for lo, hi in zip(starts, np.r_[starts[1:], n]):
            ln = int(by_len[lo])
            if ln:
                idx = order[lo:hi]
                data = b"".join([items[i] for i in idx])
                lanes[idx, :ln] = np.frombuffer(data, dtype=np.uint8).reshape(-1, ln)
        col = np.arange(n)
        lanes[col, lengths] = 0x80
        bitlen = (lengths * 8).astype(">u8").view(np.uint8).reshape(n, 8)
        end = counts.astype(np.int64) * 64
        lanes[col[:, None], end[:, None] - 8 + np.arange(8)] = bitlen
    # torch's blocked transpose: ~5x numpy's on a byte matrix
    return torch.from_numpy(lanes).t().contiguous().numpy(), counts


def sha256_batch(items):
    """A list of bytes -> their 32-byte SHA-256 digests, through the plain
    version on the CPU (an oracle for tests)."""
    if not items:
        return []
    packed, counts = pack_frames(items)
    rows = sha256_rows_from_packed(torch.from_numpy(packed), torch.from_numpy(counts))
    out = rows.to(torch.uint8).numpy()
    return [out[:, i].tobytes() for i in range(len(items))]
