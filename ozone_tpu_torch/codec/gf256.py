"""GF(2^8) arithmetic, vectorized with numpy.

Field parameters match the reference coder so output is byte-identical to
ISA-L / the reference's pure-Java coder (reference: erasurecode
rawcoder/util/RSUtil.java:34-37 — "symbol size 8, field size 256, primitive
polynomial 285, primitive root 2"; log/antilog tables in GF256.java:31-139
are generated, not copied — the same values follow from the field params).

All table construction here is programmatic.  Operations are vectorized over
numpy uint8 arrays; the hot path (bulk encode) never runs here — this module
exists for matrix construction, inversion, and as the CPU reference backend.
"""

from __future__ import annotations

import numpy as np

#: Primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D == 285), reduced low byte 0x1D.
PRIMITIVE_POLY = 0x11D
#: Primitive root (generator) of the multiplicative group.
PRIMITIVE_ROOT = 2


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build antilog (EXP) and log (LOG) tables for GF(2^8).

    EXP[i] = root^i for i in [0, 255] (EXP[255] == EXP[0] == 1);
    LOG[EXP[i]] = i, LOG[0] = 0 (unused sentinel, matches reference
    GF256.java:87 GF_LOG_BASE[0] = 0).
    """
    exp = np.zeros(256, dtype=np.uint8)
    log = np.zeros(256, dtype=np.uint8)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIMITIVE_POLY
    exp[255] = 1
    return exp, log


EXP, LOG = _build_tables()

# 256x256 full multiplication table (reference GF256.java:141-154 builds the
# same "theGfMulTab" once for the hot loop).
_A = np.arange(256, dtype=np.int32)
_LOGSUM = LOG[_A[:, None]].astype(np.int32) + LOG[_A[None, :]].astype(np.int32)
_LOGSUM = np.where(_LOGSUM > 254, _LOGSUM - 255, _LOGSUM)
MUL_TABLE = np.where(
    (_A[:, None] == 0) | (_A[None, :] == 0), 0, EXP[_LOGSUM]
).astype(np.uint8)
del _A, _LOGSUM


def gf_mul(a, b):
    """Element-wise GF(2^8) multiply of uint8 arrays (broadcasting)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return MUL_TABLE[a, b]


def gf_inv(a):
    """Element-wise multiplicative inverse; inv(0) == 0 by convention
    (reference GF256.java:178-184)."""
    a = np.asarray(a, dtype=np.uint8)
    return np.where(a == 0, 0, EXP[(255 - LOG[a].astype(np.int32)) % 255]).astype(
        np.uint8
    )


def gf_pow(a: int, n: int) -> int:
    """a^n in GF(2^8)."""
    if a == 0:
        return 0
    return int(EXP[(int(LOG[a]) * n) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: XOR-accumulate of gf_mul, shapes [m,k] @ [k,n]."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    # products[m, k, n], XOR-reduce over k
    prods = MUL_TABLE[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(prods, axis=1)


def gf_matvec(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """GF matrix-vector product [m,k] @ [k] -> [m]."""
    return gf_matmul(a, np.asarray(x, dtype=np.uint8)[:, None])[:, 0]


def gf_invert_matrix(m: np.ndarray) -> np.ndarray:
    """Invert an n*n GF(2^8) matrix by Gauss-Jordan elimination.

    Same algorithm as the reference (GF256.java:191-250, itself ported from
    ISA-L): pivot search with row swap, scale pivot row by inverse, eliminate.
    Raises ValueError on a singular matrix.
    """
    m = np.array(m, dtype=np.uint8, copy=True)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"matrix must be square, got {m.shape}")
    out = np.eye(n, dtype=np.uint8)
    for i in range(n):
        if m[i, i] == 0:
            nz = np.nonzero(m[i + 1 :, i])[0]
            if nz.size == 0:
                raise ValueError("matrix is singular")
            j = i + 1 + int(nz[0])
            m[[i, j]] = m[[j, i]]
            out[[i, j]] = out[[j, i]]
        piv_inv = gf_inv(m[i, i])
        m[i] = gf_mul(m[i], piv_inv)
        out[i] = gf_mul(out[i], piv_inv)
        for j in range(n):
            if j == i:
                continue
            c = m[j, i]
            if c:
                m[j] ^= gf_mul(c, m[i])
                out[j] ^= gf_mul(c, out[i])
    return out
