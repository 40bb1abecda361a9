"""Reed-Solomon coding matrices, ISA-L / reference compatible.

Matrix conventions follow the reference so that parity bytes are identical
to data written by the reference's Java and ISA-L coders:

- Encode matrix: (k+m) x k, identity in the top k rows, parity rows
  a[i][j] = gf_inv(i ^ j) for i in [k, k+m)  (RSUtil.genCauchyMatrix,
  reference erasurecode rawcoder/util/RSUtil.java:64-77).
- Decode: select the first k surviving rows ("valid indexes"), invert that
  k x k submatrix; rows recovering erased data units come straight from the
  inverse, rows recovering erased parity units are (encode_row_of_parity @
  inverse)  (RSRawDecoder.generateDecodeMatrix, reference
  rawcoder/RSRawDecoder.java:143-176).
"""

from __future__ import annotations

import numpy as np

from ozone_tpu_torch.codec import gf256


def encode_matrix(k: int, p: int) -> np.ndarray:
    """Full (k+p) x k Cauchy encode matrix (identity on top)."""
    if k + p >= 256:
        raise ValueError(f"k+p must be < 256, got {k}+{p}")
    m = np.zeros((k + p, k), dtype=np.uint8)
    m[:k] = np.eye(k, dtype=np.uint8)
    rows = np.arange(k, k + p, dtype=np.int64)[:, None]
    cols = np.arange(k, dtype=np.int64)[None, :]
    m[k:] = gf256.gf_inv((rows ^ cols).astype(np.uint8))
    return m


def parity_matrix(k: int, p: int) -> np.ndarray:
    """The p x k generator of parity units: parity = P @ data."""
    return encode_matrix(k, p)[k:]


def valid_indexes(available: list[int] | np.ndarray, k: int, p: int) -> list[int]:
    """First k available unit indexes in ascending order.

    Mirrors CoderUtil.getValidIndexes semantics (first k non-null inputs):
    the caller passes which of the k+p units it actually has.
    """
    avail = sorted(int(i) for i in available)
    if len(avail) < k:
        raise ValueError(f"need at least {k} available units, have {len(avail)}")
    return avail[:k]


def decode_matrix(
    k: int, p: int, erased: list[int], valid: list[int]
) -> np.ndarray:
    """len(erased) x k recovery matrix over the k valid units.

    output[e] = sum_j M[e, j] * unit[valid[j]] reconstructs unit erased[e].
    `erased` order is preserved in the output rows; data erasures must be
    listed before parity erasures by the caller if reference output-row
    ordering matters (the reference sorts data-unit erasures first via
    numErasedDataUnits bookkeeping, RSRawDecoder.java:117-176 — here rows
    are simply emitted in the caller's order, each row independently exact).
    """
    if len(valid) != k:
        raise ValueError(f"need exactly {k} valid indexes, got {len(valid)}")
    enc = encode_matrix(k, p)
    sub = enc[np.asarray(valid, dtype=np.int64)]  # k x k
    inv = gf256.gf_invert_matrix(sub)
    rows = np.zeros((len(erased), k), dtype=np.uint8)
    for r, e in enumerate(erased):
        if e < k:
            rows[r] = inv[e]
        else:
            # parity unit: re-encode from recovered data = enc_row @ inv
            rows[r] = gf256.gf_matmul(enc[e][None, :], inv)[0]
    return rows
