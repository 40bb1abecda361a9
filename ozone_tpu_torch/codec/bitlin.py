"""GF(2^8) coding as GF(2) bit-linear algebra.

Multiplication by a constant c in GF(2^8) is linear over GF(2): writing a
byte x as bits x_j (LSB-first), mul(c, x) = XOR_j x_j * mul(c, 2^j). So a
whole coding matrix M [r, k] of GF(2^8) coefficients expands to one
binary matrix A [k*8, r*8] with

    A[j*8 + bj, i*8 + bi] = bit bi of gf_mul(M[i, j], 2^bj)

and coding becomes  out_bits = (data_bits @ A) mod 2. The port's CUDA
kernel does not use this form; the plain PyTorch version
(codec/fused_kernel.gf_apply_plain) does, as `ozone_tpu`'s jax_coder does.
"""

from __future__ import annotations

import numpy as np

from ozone_tpu_torch.codec import gf256

#: LSB-first bit positions.
_BITS = np.arange(8, dtype=np.uint8)


def byte_mul_bit_matrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix B with row j = bits of gf_mul(c, 2^j), LSB-first.

    For a bit-row-vector x_bits: (x_bits @ B) mod 2 == bits of gf_mul(c, x).
    """
    prods = gf256.gf_mul(np.uint8(c), (1 << _BITS).astype(np.uint8))  # [8]
    return ((prods[:, None] >> _BITS[None, :]) & 1).astype(np.uint8)  # [8,8]


def expand_coding_matrix(m: np.ndarray) -> np.ndarray:
    """GF(2^8) coding matrix [r, k] -> GF(2) bit matrix [k*8, r*8].

    out_bits[.., r*8+bo] = XOR_{i,bi} data_bits[.., i*8+bi] * A[i*8+bi, r*8+bo].
    """
    m = np.asarray(m, dtype=np.uint8)
    r, k = m.shape
    a = np.zeros((k * 8, r * 8), dtype=np.uint8)
    for ri in range(r):
        for ki in range(k):
            a[ki * 8 : ki * 8 + 8, ri * 8 : ri * 8 + 8] = byte_mul_bit_matrix(
                int(m[ri, ki])
            )
    return a
