"""Pooled host buffers and process-wide copy accounting for the datapath.

Port of `ozone_tpu/codec/hostmem.py`: the Python half of the zero-copy
datapath (the C++ half is the arena in `csrc/datapath.cpp`, exported
through the `dp_buf_*` capsule API). Everything payload-shaped that
crosses the wire or the buffer-to-device edge routes through here, so

  * receive buffers are leased from a size-classed, page-aligned pool
    (anonymous mmaps, page-aligned by construction) instead of a fresh
    `bytearray` per frame, and
  * every host copy of payload bytes is counted in the process-wide
    `datapath` registry (`copies`, `bytes_copied`), beside the bytes that
    moved without a copy (`bytes_moved`), so the copy ratio is a gauge
    (`copy_ratio`) and a test invariant (at most one host copy per chunk
    per direction, `tests/test_torch_zero_copy.py`).

A lease that is ever handed to an asynchronous copy to the card (pinned,
or registered with `cudaHostRegister`) must stay held until that copy's
event has fired, or a recycled slab is overwritten under the DMA.
`to_device` copies synchronously, so a lease may be released as soon as
it returns.

Environment (the reference's names):
  OZONE_TPU_POOL_MAX_MIB        bytes the pool retains on its free lists
                                (default 256); leases past it are unmapped
  OZONE_TPU_POOL_MAX_CLASS_MIB  largest size class retained (default 256,
                                so a whole-block GET slab is recycled);
                                bigger leases are transient
  OZONE_TPU_POOL_MIN_CLASS      smallest size class in bytes (default
                                4096, one page)
"""

from __future__ import annotations

import logging
import mmap
import os
import sys
import threading
import warnings
import weakref
from typing import Optional, Union

import numpy as np

from ozone_tpu_torch.utils.metrics import registry

log = logging.getLogger(__name__)

#: process-wide copy and pool accounting
METRICS = registry("datapath")
_COPIES = METRICS.counter("copies")
_BYTES_COPIED = METRICS.counter("bytes_copied")
_BYTES_MOVED = METRICS.counter("bytes_moved")
_RATIO = METRICS.gauge("copy_ratio")
_POOL_LEASED = METRICS.gauge("pool_leased_bytes")
_POOL_FREE = METRICS.gauge("pool_free_bytes")
_POOL_HIGH = METRICS.gauge("pool_high_water_bytes")

_logged_sites: set[str] = set()
_logged_lock = threading.Lock()

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _site(depth: int = 2) -> str:
    """`file.py:lineno` of the caller `depth` frames up: the key of the
    once-per-site copy warning."""
    try:
        f = sys._getframe(depth)
    except ValueError:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _update_ratio() -> None:
    moved = _BYTES_MOVED.value
    _RATIO.set(_BYTES_COPIED.value / moved if moved else 0.0)


def count_copy(nbytes: int, site: Optional[str] = None,
               warn: bool = True) -> None:
    """Record one host copy of `nbytes` payload bytes. An unexpected copy
    (`warn=True`) is logged once per call site, so a hidden fallback shows
    once in the log and always in the registry."""
    where = site or _site(2)
    _COPIES.inc()
    _BYTES_COPIED.inc(int(nbytes))
    _update_ratio()
    if warn:
        with _logged_lock:
            first = where not in _logged_sites
            _logged_sites.add(where)
        if first:
            log.warning("datapath host copy at %s (%d bytes): payload left "
                        "the zero-copy path (counted in datapath.copies)",
                        where, nbytes)


def count_move(nbytes: int) -> None:
    """Record `nbytes` of payload that crossed a hop without a host copy."""
    _BYTES_MOVED.inc(int(nbytes))
    _update_ratio()


class Lease:
    """A refcounted slice of pool memory. The creator holds one reference;
    each `array()` takes another, dropped when that array is collected, so
    the buffer is recycled only after the last view is gone."""

    __slots__ = ("_pool", "_mm", "cap", "size", "_refs", "__weakref__")

    def __init__(self, pool: "HostBufferPool", mm: mmap.mmap, cap: int,
                 size: int):
        self._pool = pool
        self._mm = mm
        self.cap = cap
        self.size = size
        self._refs = 1

    @property
    def view(self) -> memoryview:
        """Writable view of the leased bytes; valid while a reference is
        held."""
        return memoryview(self._mm)[: self.size]

    def retain(self) -> None:
        with self._pool._lock:
            if self._refs <= 0:
                raise RuntimeError("retain() on a released lease")
            self._refs += 1

    def release(self) -> None:
        with self._pool._lock:
            if self._refs <= 0:
                raise RuntimeError("release() on a released lease")
            self._refs -= 1
            last = self._refs == 0
        if last:
            self._pool._recycle(self._mm, self.cap)

    def array(self, length: Optional[int] = None,
              offset: int = 0) -> np.ndarray:
        """Zero-copy uint8 array over `[offset, offset + length)` of the
        lease; it pins the buffer until it (and every view of it) is
        collected."""
        n = self.size - offset if length is None else int(length)
        arr = np.frombuffer(self._mm, dtype=np.uint8, count=n, offset=offset)
        self.retain()
        weakref.finalize(arr, self.release)
        return arr

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class HostBufferPool:
    """Size-classed free lists of page-aligned mmap buffers. Classes are
    powers of two from `min_class`; a lease takes the smallest that fits.
    Released buffers are kept up to `max_retained` bytes in all, and only
    for classes up to `max_class`; the rest are unmapped."""

    def __init__(self, max_retained: Optional[int] = None,
                 max_class: Optional[int] = None,
                 min_class: Optional[int] = None):
        self._lock = threading.Lock()
        self.min_class = min_class or _env_int("OZONE_TPU_POOL_MIN_CLASS",
                                               4096)
        self.max_class = max_class or _env_int(
            "OZONE_TPU_POOL_MAX_CLASS_MIB", 256) * (1 << 20)
        self.max_retained = (max_retained if max_retained is not None
                             else _env_int("OZONE_TPU_POOL_MAX_MIB", 256)
                             * (1 << 20))
        self._free: dict[int, list[mmap.mmap]] = {}
        self.leased_bytes = 0
        self.leased_count = 0
        self.free_bytes = 0
        self.high_water_bytes = 0

    def _class_for(self, n: int) -> int:
        cap = self.min_class
        while cap < n:
            cap <<= 1
        return cap

    def lease(self, n: int) -> Lease:
        if n < 0:
            raise ValueError(f"negative lease size {n}")
        cap = self._class_for(max(n, 1))
        mm: Optional[mmap.mmap] = None
        with self._lock:
            lst = self._free.get(cap)
            if lst:
                mm = lst.pop()
                self.free_bytes -= cap
        if mm is None:
            mm = mmap.mmap(-1, cap)  # anonymous, so page-aligned
        with self._lock:
            self.leased_bytes += cap
            self.leased_count += 1
            self.high_water_bytes = max(self.high_water_bytes,
                                        self.leased_bytes)
            self._publish_locked()
        return Lease(self, mm, cap, n)

    def _recycle(self, mm: mmap.mmap, cap: int) -> None:
        with self._lock:
            self.leased_bytes -= cap
            self.leased_count -= 1
            retain = (cap <= self.max_class
                      and self.free_bytes + cap <= self.max_retained)
            if retain:
                self._free.setdefault(cap, []).append(mm)
                self.free_bytes += cap
            self._publish_locked()
        if not retain:
            _unmap(mm)

    def _publish_locked(self) -> None:
        _POOL_LEASED.set(float(self.leased_bytes))
        _POOL_FREE.set(float(self.free_bytes))
        _POOL_HIGH.set(float(self.high_water_bytes))

    def stats(self) -> dict:
        with self._lock:
            return {"leased_count": self.leased_count,
                    "leased_bytes": self.leased_bytes,
                    "free_bytes": self.free_bytes,
                    "high_water_bytes": self.high_water_bytes}

    def trim(self) -> None:
        """Unmap every retained free buffer."""
        with self._lock:
            drop = [mm for lst in self._free.values() for mm in lst]
            self._free.clear()
            self.free_bytes = 0
            self._publish_locked()
        for mm in drop:
            _unmap(mm)


def _unmap(mm: mmap.mmap) -> None:
    try:
        mm.close()
    except BufferError:
        # a stray exported view still maps it; the collector unmaps it
        log.debug("pool buffer still exported; unmapped when collected")


_pool: Optional[HostBufferPool] = None
_pool_lock = threading.Lock()


def pool() -> HostBufferPool:
    """The process-wide pool (the native client's receive slabs)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = HostBufferPool()
        return _pool


def as_array(data: BytesLike) -> np.ndarray:
    """Flat uint8 view of `data`, with no copy for bytes, bytearray,
    memoryview, mmap and contiguous uint8 arrays; otherwise one copy,
    counted."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8 and data.flags.c_contiguous:
            return data.reshape(-1)
        count_copy(data.nbytes, site=_site(2))
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if isinstance(data, (bytes, bytearray, memoryview, mmap.mmap)):
        try:
            return np.frombuffer(data, dtype=np.uint8)
        except (ValueError, BufferError):
            # a non-contiguous memoryview: one counted copy
            count_copy(len(data), site=_site(2))
            return np.frombuffer(bytes(data), dtype=np.uint8)
    arr = np.asarray(data)
    if arr.dtype == np.uint8 and arr.flags.c_contiguous:
        return arr.reshape(-1)
    count_copy(int(arr.nbytes), site=_site(2))
    return np.ascontiguousarray(arr, dtype=np.uint8).reshape(-1)


def to_device(data: BytesLike, device):
    """Host payload to `device` as one uint8 tensor: a flat view (no copy
    for pooled and wire buffers), then one synchronous `.to(device)`,
    counted as moved. On the CPU the tensor aliases the buffer."""
    import torch

    arr = as_array(data)
    count_move(int(arr.nbytes))
    with warnings.catch_warnings():
        # a view of read-only bytes: the tensor is only read
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.to(torch.device(device))
