"""Host buffers: the one bytes-like -> flat uint8 array helper.

Trimmed port of `ozone_tpu/codec/hostmem.py` (`as_array` only; the pooled
leases and copy accounting are not ported yet).
"""

from __future__ import annotations

import mmap

import numpy as np


def as_array(data) -> np.ndarray:
    """Flat uint8 view of `data`, with no copy for bytes, bytearray,
    memoryview, mmap and contiguous uint8 arrays; one copy otherwise."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8 and data.flags.c_contiguous:
            return data.reshape(-1)
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if isinstance(data, (bytes, bytearray, memoryview, mmap.mmap)):
        try:
            return np.frombuffer(data, dtype=np.uint8)
        except (ValueError, BufferError):
            return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.ascontiguousarray(np.asarray(data), dtype=np.uint8).reshape(-1)
