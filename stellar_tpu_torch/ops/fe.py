"""Batched GF(2^255-19) arithmetic in plain PyTorch.

The plain version of the field arithmetic under the verify kernel, with the
JAX package's layout kept so the two compare limb for limb: **radix 2^13,
20 int32 limbs, batch last** — a field element is a ``(20, *N)`` int32
tensor.  Bounds that keep int32 exact throughout (no wrap ever happens):

- weakly-reduced elements have limbs < 2^13 + 4, value < 2^255 + ε
- schoolbook products: ≤ 20 terms × (2^13+3)² < 2^31
- 2^260 ≡ 608 (mod p) folds the high 19 limbs back, split into a low and
  a carry part so the fold multiplies cannot overflow either

Every function is shape-polymorphic in the trailing dims and runs on the
device its inputs lie on; constants follow the input's device.  ``>>`` on
int32 tensors is an arithmetic shift, so negative limbs borrow correctly.
"""

from __future__ import annotations

import numpy as np
import torch

P = 2**255 - 19
LIMBS = 20
RADIX = 13
MASK = (1 << RADIX) - 1  # 8191
FOLD = 608  # 2^260 mod p = 19 * 2^5


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> (20,) int32 limb vector (host-side)."""
    out = np.zeros(LIMBS, dtype=np.int32)
    for i in range(LIMBS):
        out[i] = v & MASK
        v >>= RADIX
    assert v == 0
    return out


def limbs_to_int(l) -> int:
    l = np.asarray(l)
    return sum(int(l[i]) << (RADIX * i) for i in range(LIMBS))


def _sub_pad_limbs() -> np.ndarray:
    """4p written with every limb >= 2^14 (limb 19 >= 2^9): ``a - b + pad``
    then has all-positive limbs for weakly-reduced a, b, so the parallel
    carry passes never ripple borrows.  Built by borrowing 2 units of each
    limb's radix from the limb above (value preserved)."""
    four_p = 4 * P
    l = np.zeros(LIMBS, dtype=np.int64)
    v = four_p
    for i in range(LIMBS):
        l[i] = v & MASK if i < LIMBS - 1 else v
        v >>= RADIX
    assert l[LIMBS - 1] >= 2 + 512, l[LIMBS - 1]  # room to borrow 2
    d = l.copy()
    d[0] += 2 << RADIX
    for i in range(1, LIMBS - 1):
        d[i] += (2 << RADIX) - 2
    d[LIMBS - 1] -= 2
    assert sum(int(d[i]) << (RADIX * i) for i in range(LIMBS)) == four_p
    assert all(d[i] >= 2 * MASK for i in range(LIMBS - 1)) and d[LIMBS - 1] >= 512
    return d.astype(np.int32)


SUB_PAD = torch.from_numpy(_sub_pad_limbs()).reshape(LIMBS, 1)
P_LIMBS_COL = torch.from_numpy(int_to_limbs(P)).reshape(LIMBS, 1)

# module constants keyed by (id, device): each device gets its own copy
# once, so the plain version on the card does no host->device copy per op
_DEV_CONSTS: dict = {}


def to_device(c: torch.Tensor, device) -> torch.Tensor:
    """The module-level CPU constant ``c`` on ``device`` (cached)."""
    key = (id(c), device)
    t = _DEV_CONSTS.get(key)
    if t is None:
        t = _DEV_CONSTS[key] = c.to(device)
    return t


def on_device(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The (20, 1) CPU constant ``c`` on ``like``'s device, shaped to
    broadcast against ``like``'s trailing dims."""
    t = to_device(c, like.device)
    if like.dim() != t.dim():
        t = t.reshape(t.shape[:1] + (1,) * (like.dim() - 1))
    return t


def const_fe(v: int) -> torch.Tensor:
    """(20, 1) broadcastable constant, on the CPU (see ``on_device``)."""
    return torch.from_numpy(int_to_limbs(v % P)).reshape(LIMBS, 1)


def one_fe(n, dtype=torch.int32, device=None) -> torch.Tensor:
    """(20, *n) field element 1."""
    shape = n if isinstance(n, tuple) else (n,)
    out = torch.zeros((LIMBS,) + shape, dtype=dtype, device=device)
    out[0] = 1
    return out


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """ONE data-parallel carry pass over all limbs at once.  Limbs 0..18
    carry at 2^13; limb 19 holds bits 247..254 and folds its overflow back
    to limb 0 via 2^255 ≡ 19 (mod p)."""
    k = x.shape[0] - 1
    c_lo = x[:k] >> RADIX
    r_lo = x[:k] - (c_lo << RADIX)
    c_hi = x[k] >> 8
    r_hi = x[k] - (c_hi << 8)
    carries = torch.cat([(c_hi * 19)[None], c_lo], dim=0)
    return torch.cat([r_lo, r_hi[None]], dim=0) + carries


def carry(x: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Parallel carry -> weakly reduced (limbs <= 2^13 + 3).  Products
    after the fold have limbs < 2^31 -> 3 passes; add/sub inputs <= 2^14.6
    need only 2."""
    for _ in range(passes):
        x = _carry_pass(x)
    return x


def carry_exact(x: torch.Tensor) -> torch.Tensor:
    """Sequential full chain: limbs land exactly in [0, 2^13) (limb 19 in
    [0, 2^8)).  Only for ``canonical``; the hot path uses ``carry``."""
    limbs = [x[i] for i in range(LIMBS)]
    for i in range(LIMBS - 1):
        c = limbs[i] >> RADIX
        limbs[i] = limbs[i] - (c << RADIX)
        limbs[i + 1] = limbs[i + 1] + c
    t = limbs[LIMBS - 1] >> 8
    limbs[LIMBS - 1] = limbs[LIMBS - 1] & 0xFF
    limbs[0] = limbs[0] + t * 19
    for i in range(2):
        c = limbs[i] >> RADIX
        limbs[i] = limbs[i] - (c << RADIX)
        limbs[i + 1] = limbs[i + 1] + c
    return torch.stack(limbs)


def add(a, b):
    # both weakly reduced (<= MASK+3): sums <= 2^14, 2 passes suffice
    return carry(a + b, passes=2)


def sub(a, b):
    # a - b + pad: pad has every limb >= 2^13+ε, so limbs stay positive —
    # no borrow ripple, 2 passes suffice
    return carry(a - b + on_device(SUB_PAD, a), passes=2)


def neg(a):
    return carry(on_device(SUB_PAD, a) - a, passes=2)


# column index i + j of the product a_i * b_j, flattened over (i, j)
_COLS = torch.arange(LIMBS).reshape(LIMBS, 1) + torch.arange(LIMBS).reshape(1, LIMBS)
_COLS = _COLS.reshape(-1)


def mul(a, b):
    """Schoolbook multiply + parallel fold + carry.

    All 400 limb products at once, summed into their 39 columns with one
    ``index_add_``.  Integer sums are exact in any order (every column is
    < 20·(2^13+3)^2 < 2^31), so this equals the JAX package's
    accumulate-by-rows loop limb for limb."""
    n = a.shape[1:]
    outer = (a[:, None] * b[None, :]).reshape((LIMBS * LIMBS,) + n)
    prod = torch.zeros((2 * LIMBS - 1,) + n, dtype=torch.int32, device=a.device)
    prod.index_add_(0, to_device(_COLS, a.device), outer)
    return _fold_and_carry(prod, n)


def _fold_and_carry(prod, n):
    """(39, ...) product columns -> weakly-reduced (20, ...) element: fold
    the 19 high limbs back with 2^260 ≡ 608 (mod p), split so no int32
    overflow, then 3 parallel carry passes."""
    lo = prod[:LIMBS]
    hi = prod[LIMBS:]  # 19 limbs, each < 2^31
    hi_lo = hi & MASK
    hi_hi = hi >> RADIX
    zero = torch.zeros((1,) + n, dtype=torch.int32, device=prod.device)
    lo = lo + torch.cat([hi_lo * FOLD, zero], dim=0)
    lo = lo + torch.cat([zero, hi_hi * FOLD], dim=0)
    return carry(lo, passes=3)


def sqr(a):
    return mul(a, a)


def mul_small(a, k: int):
    """Multiply by a small scalar constant (k < 2^17)."""
    return carry(a * k)


def _sq_n(x, n: int):
    for _ in range(n):
        x = sqr(x)
    return x


def _pow_core(z):
    """Shared prefix of the classic curve25519 exponentiation chains:
    returns (z^(2^250 - 1), z^11, z^(2^5 - 1))."""
    t0 = sqr(z)  # 2
    t1 = mul(z, _sq_n(t0, 2))  # 9
    t0 = mul(t0, t1)  # 11
    t2 = sqr(t0)  # 22
    t1 = mul(t1, t2)  # 31 = 2^5 - 1
    z5 = t1
    t2 = _sq_n(t1, 5)
    t1 = mul(t1, t2)  # 2^10 - 1
    t2 = mul(_sq_n(t1, 10), t1)  # 2^20 - 1
    t3 = mul(_sq_n(t2, 20), t2)  # 2^40 - 1
    t2 = mul(_sq_n(t3, 10), t1)  # 2^50 - 1
    t3 = mul(_sq_n(t2, 50), t2)  # 2^100 - 1
    t4 = mul(_sq_n(t3, 100), t3)  # 2^200 - 1
    t3 = mul(_sq_n(t4, 50), t2)  # 2^250 - 1
    return t3, t0, z5


def inv(z):
    """z^(p-2) = z^(2^255 - 21)."""
    t3, z11, _ = _pow_core(z)
    return mul(_sq_n(t3, 5), z11)  # 2^255 - 32 + 11 = 2^255 - 21


def pow_p58(z):
    """z^((p-5)/8) = z^(2^252 - 3)."""
    t3, _, _ = _pow_core(z)
    return mul(_sq_n(t3, 2), z)  # 2^252 - 4 + 1 = 2^252 - 3


def inv_batch(z, min_width: int = 128):
    """Montgomery-style batched inversion across the lane (batch) axis:
    tree-reduce the batch by pairwise lane products down to ``min_width``,
    run the ladder once at that width, then expand the inverses back up
    (from i = 1/(a·b): 1/a = i·b, 1/b = i·a).

    Zero lanes are substituted with 1 first, so their output slot is
    garbage (NOT 0, unlike ``inv``) — callers must already mask them."""
    n = z.shape[1]
    if n <= min_width or n % 2:
        return inv(z)
    zero = is_zero(z)
    cur = select(zero, one_fe(tuple(z.shape[1:]), z.dtype, z.device), z)
    levels = [cur]
    while cur.shape[1] > min_width and cur.shape[1] % 2 == 0:
        half = cur.shape[1] // 2
        cur = mul(cur[:, :half], cur[:, half:])
        levels.append(cur)
    invs = inv(cur)
    for lvl in reversed(levels[:-1]):
        half = lvl.shape[1] // 2
        inv_lo = mul(invs, lvl[:, half:])
        inv_hi = mul(invs, lvl[:, :half])
        invs = torch.cat([inv_lo, inv_hi], dim=1)
    return invs


_P_LIMBS = [int(v) for v in int_to_limbs(P)]


def canonical(x):
    """Weakly-reduced -> fully reduced (< p), canonical limbs."""
    x = carry_exact(x)
    # weakly reduced: x < p + ε < 2p, so at most one subtraction of p.
    # lexicographic compare with p from the top limb down: x >= p?
    eq_so_far = torch.ones_like(x[0], dtype=torch.bool)
    gt = torch.zeros_like(x[0], dtype=torch.bool)
    for i in range(LIMBS - 1, -1, -1):
        pi = _P_LIMBS[i]
        gt = gt | (eq_so_far & (x[i] > pi))
        eq_so_far = eq_so_far & (x[i] == pi)
    need_sub = gt | eq_so_far
    sub_p = on_device(P_LIMBS_COL, x)
    return carry_exact(x - torch.where(need_sub[None], sub_p, 0))


def eq(a, b):
    return torch.all(canonical(a) == canonical(b), dim=0)


def is_zero(a):
    return torch.all(canonical(a) == 0, dim=0)


def parity(a):
    """Least-significant bit of the canonical value."""
    return canonical(a)[0] & 1


def select(cond, a, b):
    """cond: (N,) bool; a, b: (20, N)."""
    return torch.where(cond[None], a, b)


# -- byte conversion ---------------------------------------------------------
def limbs_from_bytes(b):
    """(32, N) int32 bytes (little-endian) -> (20, N) limbs.  The caller
    masks the sign bit out of byte 31 first if decoding a point."""
    limbs = []
    for k in range(LIMBS):
        bit0 = RADIX * k
        j0, r0 = divmod(bit0, 8)
        acc = b[j0] >> r0
        width = 8 - r0
        j = j0 + 1
        while width < RADIX and j < 32:
            acc = acc | (b[j] << width)
            width += 8
            j += 1
        limbs.append(acc & MASK)
    return torch.stack(limbs)


def bytes_from_limbs(x):
    """canonical (20, N) limbs -> (32, N) int32 bytes little-endian."""
    out = []
    for j in range(32):
        bit0 = 8 * j
        k0, r0 = divmod(bit0, RADIX)
        acc = x[k0] >> r0
        width = RADIX - r0
        if width < 8 and k0 + 1 < LIMBS:
            acc = acc | (x[k0 + 1] << width)
        out.append(acc & 0xFF)
    return torch.stack(out)
