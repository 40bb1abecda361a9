"""Host buffers: the bytes-like -> flat uint8 array helper and the copy
counter.

Trimmed port of `ozone_tpu/codec/hostmem.py`: `as_array`, and
`count_copy`, which counts host copies of payload bytes in the `datapath`
registry (`copies`, `bytes_copied`). The pooled leases, the once-per-site
copy warning, moved-byte accounting and the device handoff are not
ported yet.
"""

from __future__ import annotations

import mmap

import numpy as np

from ozone_tpu_torch.utils.metrics import MetricsRegistry

#: process-wide copy accounting
METRICS = MetricsRegistry("datapath")


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


def count_copy(nbytes: int) -> None:
    """Record one host copy of `nbytes` payload bytes."""
    METRICS.counter("copies").inc()
    METRICS.counter("bytes_copied").inc(int(nbytes))
