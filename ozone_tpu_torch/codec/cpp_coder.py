"""C++ (ISA-L-class) erasure coder backend: the host GF(2^8) library.

Port of `ozone_tpu/codec/cpp_coder.py`. The library is the port's own
`csrc/gf_coder.cpp`, built by `cuda_build` with g++ -O3 -march=native
-pthread at first use and loaded with ctypes (which releases the
interpreter lock for the call). Bit-identical to the numpy and torch
backends; registered between them (codec/registry.py), as the
reference's native coder sits between its device and pure coders.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ozone_tpu_torch.codec import gf256, rs_math
from ozone_tpu_torch.codec.api import CoderOptions, RawErasureDecoder, RawErasureEncoder

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nibble_tables(matrix: np.ndarray) -> np.ndarray:
    """Per-coefficient 32-byte nibble product tables (GF256.gfVectMulInit
    layout: 16 low-nibble products then 16 high-nibble products)."""
    rows, k = matrix.shape
    nib = np.arange(16, dtype=np.uint8)
    out = np.zeros((rows, k, 32), dtype=np.uint8)
    for r in range(rows):
        for j in range(k):
            c = matrix[r, j]
            out[r, j, :16] = gf256.gf_mul(c, nib)
            out[r, j, 16:] = gf256.gf_mul(c, (nib << 4).astype(np.uint8))
    return np.ascontiguousarray(out.reshape(-1))


def load() -> ctypes.CDLL:
    """The GF coder library, built on first use; raises when it cannot be
    built (no compiler)."""
    global _lib
    with _lock:
        if _lib is None:
            from ozone_tpu_torch import cuda_build

            lib = cuda_build.load("gf_coder")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.gf_matrix_apply.argtypes = [p, i, i, p, p, i64]
            lib.gf_matrix_apply.restype = None
            lib.gf_matrix_apply_batch.argtypes = [p, i, i, p, p, i64, i64]
            lib.gf_matrix_apply_batch.restype = None
            lib.gf_matrix_apply_batch_mt.argtypes = [p, i, i, p, p, i64, i64, i]
            lib.gf_matrix_apply_batch_mt.restype = None
            lib.gf_coder_probe.argtypes = []
            lib.gf_coder_probe.restype = i
            _lib = lib
        return _lib


def probe() -> int:
    """What the library's GF multiply compiled to: 2 for AVX2, 0 for the
    scalar table loop."""
    return int(load().gf_coder_probe())


#: don't spin up threads below this much input (thread startup would
#: dominate); above it the stripes split across a one-shot pool
_MT_THRESHOLD_BYTES = 4 * 1024 * 1024


def _default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def _apply(lib, tables: np.ndarray, rows: int, k: int,
           data: np.ndarray, threads: int = 0) -> np.ndarray:
    batch, _, n = data.shape
    data = np.ascontiguousarray(data)
    out = np.empty((batch, rows, n), dtype=np.uint8)
    if threads == 0 and batch > 1 \
            and data.nbytes >= _MT_THRESHOLD_BYTES:
        threads = _default_threads()
    if threads > 1:
        lib.gf_matrix_apply_batch_mt(
            tables.ctypes.data, rows, k, data.ctypes.data, out.ctypes.data,
            n, batch, threads,
        )
    else:
        lib.gf_matrix_apply_batch(
            tables.ctypes.data, rows, k, data.ctypes.data, out.ctypes.data,
            n, batch,
        )
    return out


class CppRSEncoder(RawErasureEncoder):
    def __init__(self, options: CoderOptions):
        super().__init__(options)
        self._lib = load()
        self._tables = _nibble_tables(rs_math.parity_matrix(self.k, self.p))

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return _apply(self._lib, self._tables, self.p, self.k, data)


class CppRSDecoder(RawErasureDecoder):
    def __init__(self, options: CoderOptions):
        super().__init__(options)
        self._lib = load()
        self._cache: dict[tuple, np.ndarray] = {}

    def do_decode(self, valid_data, valid, erased):
        key = (tuple(valid), tuple(erased))
        tables = self._cache.get(key)
        if tables is None:
            dm = rs_math.decode_matrix(self.k, self.p, erased, valid)
            tables = _nibble_tables(dm)
            self._cache[key] = tables
        return _apply(self._lib, tables, len(erased), self.k, valid_data)


def crc32c_native(data: np.ndarray, prev: int = 0) -> int:
    """Hardware CRC32C through the port's host CRC32C library (the one
    `utils/checksum` loads; this module keeps no second copy)."""
    from ozone_tpu_torch.utils import checksum

    lib = checksum._native_lib()
    if lib is None:
        raise RuntimeError("host CRC32C library unavailable")
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8).reshape(-1))
    return int(lib.crc32c_hw(data.ctypes.data, data.size, prev))
