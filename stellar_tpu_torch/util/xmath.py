"""128-bit-safe integer math (reference: src/util/types.cpp bigDivide, using
the vendored uint128; Python ints are unbounded so only the overflow contract
needs care).
"""

from __future__ import annotations

INT64_MAX = 0x7FFFFFFFFFFFFFFF
INT64_MIN = -0x8000000000000000


def big_divide_checked(a: int, b: int, c: int):
    """floor(a*b/c) with int64 range check -> (ok, result)."""
    assert a >= 0 and b >= 0 and c > 0
    x = (a * b) // c
    if x > INT64_MAX:
        return False, 0
    return True, x


def big_divide(a: int, b: int, c: int) -> int:
    ok, r = big_divide_checked(a, b, c)
    if not ok:
        raise OverflowError("overflow while performing bigDivide")
    return r
