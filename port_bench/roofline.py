"""The yardstick of the kernels' roofline shares: the card's peaks and the
work that one lane of the verify plane needs, whatever kernel does it.

Peaks of one NVIDIA H100 SXM at its 700 W limit: 132 SMs x 64 INT32 lanes x
1.98 GHz boost clock (NVIDIA H100 Tensor Core GPU Architecture white paper),
and 3.35 TB/s of HBM3 (NVIDIA H100 data sheet).

Operations are counted as 32-bit integer instructions, as the kernels'
header notes and PERF.md count them:

- a 255-bit field multiplication on eight 32-bit words: 64 word products,
  each a low and a high half (128), plus the x38 fold of the reduction on
  eight words, low and high (16): 144; a squaring: 36 distinct products
  (72) plus the fold (16): 88.
- B1, one verify (``csrc/ed25519_verify.cu``, or any kernel in its place):
  decompressing A: 255 squarings and 18 multiplications (the exponentiation
  to (p - 5) / 8, 251 squarings and 11 multiplications, and the u, v, v^3,
  v^7 and check around it); the double-scalar multiplication [S]B + [h](-A)
  over 64 radix-16 windows: four doublings a window (16 squarings and 16
  multiplications) and two table additions (12 multiplications); the table
  of k * (-A) for the signed digits k = 0..8 (72 multiplications, the
  smaller of the port's two tables).  The final check of R is left out.
- B2, one lane hashed on the card (``csrc/sha512_h.cu``): one SHA-512 block
  (80 rounds x 28, 64 schedule words x 20, the feed-forward 16), assembling
  the block from R, A and the message (210) and reducing the digest mod L
  (510).

Bytes: B1 reads a lane's 128 packed bytes and writes its verdict; B2 reads
R, A, the message, its length and flag (114) and writes h (32).
"""

INT32_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12

IMAD_PER_FIELD_MUL = 2 * 64 + 2 * 8
IMAD_PER_FIELD_SQR = 2 * 36 + 2 * 8
B1_FIELD_SQRS = 255 + 64 * 16
B1_FIELD_MULS = 18 + 64 * (16 + 12) + 72
B1_OPS_PER_LANE = B1_FIELD_MULS * IMAD_PER_FIELD_MUL + B1_FIELD_SQRS * IMAD_PER_FIELD_SQR
B1_BYTES_PER_LANE = 128 + 1
B2_OPS_PER_LANE = 80 * 28 + 64 * 20 + 16 + 210 + 510
B2_BYTES_PER_LANE = 114 + 32

# what the kernels' names in a device trace contain: B1 and the signed
# windows' kernels are all ``ed25519_verify*``
B1_KERNEL = "ed25519_verify"
B2_KERNEL = "sha512_h"

# the most bytes of a message that fit one SHA-512 block behind R and A
ONE_BLOCK_MSG = 128 - 17 - 64


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card takes for ``ops`` instructions moving
    ``nbytes``: the larger of the two bounds."""
    return max(ops / INT32_PER_S, nbytes / BYTES_PER_S)


def share_pct(lanes: int, ops_per_lane: int, bytes_per_lane: int, seconds: float):
    """The share of the roofline that ``lanes`` lanes took in ``seconds`` of
    kernel time, in %; None when there is nothing to read."""
    if lanes <= 0 or seconds <= 0:
        return None
    return 100.0 * least_seconds(lanes * ops_per_lane, lanes * bytes_per_lane) / seconds
