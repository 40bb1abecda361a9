"""GF(2^8) as Ozone's and ISA-L's Reed-Solomon coders define it: the field
modulo x^8 + x^4 + x^3 + x^2 + 1 (0x11D), and the RS generator's parity
rows a[i][j] = 1 / (i XOR j) for i in [k, k + p), j in [0, k) (Hadoop's
RSUtil.genCauchyMatrix)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

PRIMITIVE = 0x11D


def mul_slow(a: int, b: int) -> int:
    """Carry-less product of a and b, reduced modulo 0x11D, bit by bit."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= PRIMITIVE
    return out


@lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """[256, 256] uint8: mul_table()[a, b] = a * b in the field."""
    table = np.zeros((256, 256), dtype=np.uint8)
    b = np.arange(256, dtype=np.int64)
    for a in range(256):
        # shift-and-add over the bits of a, every b at once
        acc = np.zeros(256, dtype=np.int64)
        x = b.copy()
        for bit in range(8):
            if a >> bit & 1:
                acc ^= x
            x <<= 1
            x = np.where(x & 0x100, x ^ PRIMITIVE, x)
        table[a] = acc
    return table


def inverse(a: int) -> int:
    """The multiplicative inverse of a nonzero field element."""
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    row = mul_table()[a]
    return int(np.flatnonzero(row == 1)[0])


def parity_matrix(k: int, p: int) -> np.ndarray:
    """[p, k] uint8: the rows that make the p parity units from k data
    units (parity[i] = sum_j a[i][j] * data[j])."""
    if k + p > 256:
        raise ValueError(f"RS({k},{p}) has more units than the field")
    return np.array([[inverse(i ^ j) for j in range(k)]
                     for i in range(k, k + p)], dtype=np.uint8)
