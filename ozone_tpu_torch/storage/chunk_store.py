"""Chunk IO: one file per block, chunks written at their block offset.

Port of `ozone_tpu/storage/chunk_store.py` (the reference datanode's
FilePerBlockStrategy). Writes are zero-copy `os.pwrite`s of the caller's
buffer through a bounded per-store cache of open descriptors; reads are
`os.pread`s on the same descriptors. Descriptors are refcounted, so the
store lock covers only cache bookkeeping and the syscalls run outside it.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ozone_tpu_torch.storage.ids import (
    INVALID_WRITE_SIZE,
    IO_EXCEPTION,
    BlockID,
    ChunkInfo,
    StorageError,
)

#: open block-file descriptors kept per store (= per container)
_FD_CACHE_CAP = 16


class _CachedFd:
    __slots__ = ("fd", "refs", "evicted")

    def __init__(self, fd: int):
        self.fd = fd
        self.refs = 0
        self.evicted = False


class FilePerBlockStore:
    """Chunks of a block live in one file `<chunks_dir>/<local_id>.block`."""

    def __init__(self, chunks_dir: Path):
        self.chunks_dir = Path(chunks_dir)
        self.chunks_dir.mkdir(parents=True, exist_ok=True)
        self._fds: OrderedDict[int, _CachedFd] = OrderedDict()
        self._lock = threading.Lock()

    def block_path(self, block_id: BlockID) -> Path:
        return self.chunks_dir / f"{block_id.local_id}.block"

    # ------------------------------------------------------------- fd cache
    def _acquire(self, block_id: BlockID, create: bool) -> _CachedFd:
        """Pin a cached descriptor for a block file; release with _release."""
        lid = block_id.local_id
        with self._lock:
            ent = self._fds.get(lid)
            if ent is None:
                flags = os.O_RDWR | (os.O_CREAT if create else 0)
                ent = _CachedFd(os.open(self.block_path(block_id), flags))
                self._fds[lid] = ent
                # evict idle LRU entries past the cap; pinned entries stay
                idle = [k for k, e in self._fds.items() if e.refs == 0
                        and k != lid]
                for k in idle[: max(0, len(self._fds) - _FD_CACHE_CAP)]:
                    self._close_entry(self._fds.pop(k))
            else:
                self._fds.move_to_end(lid)
            ent.refs += 1
            return ent

    def _release(self, ent: _CachedFd) -> None:
        with self._lock:
            ent.refs -= 1
            if ent.evicted and ent.refs == 0:
                self._close_entry(ent)

    @staticmethod
    def _close_entry(ent: _CachedFd) -> None:
        if ent.fd >= 0:
            try:
                os.close(ent.fd)
            except OSError:  # best-effort eviction: nothing to recover
                pass
            ent.fd = -1

    def close(self) -> None:
        """Release every cached descriptor."""
        with self._lock:
            for lid in list(self._fds):
                ent = self._fds.pop(lid)
                if ent.refs == 0:
                    self._close_entry(ent)
                else:
                    ent.evicted = True  # the last _release closes it

    # ------------------------------------------------------------- chunk IO
    def write_chunk(self, block_id: BlockID, info: ChunkInfo, data,
                    sync: bool = False) -> None:
        if isinstance(data, (bytes, bytearray, memoryview)):
            try:
                view = memoryview(data).cast("B")
            except (TypeError, ValueError):
                view = memoryview(bytes(data))
        else:
            arr = np.asarray(data)
            if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr, dtype=np.uint8)
            view = memoryview(arr.reshape(-1))
        if len(view) != info.length:
            raise StorageError(
                INVALID_WRITE_SIZE,
                f"chunk {info.name}: data {len(view)} != declared "
                f"{info.length}",
            )
        try:
            ent = self._acquire(block_id, create=True)
        except OSError as e:
            raise StorageError(
                IO_EXCEPTION, f"write {self.block_path(block_id)}: {e}"
            ) from e
        try:
            written = 0
            while written < len(view):
                written += os.pwrite(ent.fd, view[written:],
                                     info.offset + written)
            if sync:
                os.fsync(ent.fd)
        except OSError as e:
            raise StorageError(
                IO_EXCEPTION, f"write {self.block_path(block_id)}: {e}"
            ) from e
        finally:
            self._release(ent)

    def read_chunk(self, block_id: BlockID, info: ChunkInfo) -> np.ndarray:
        try:
            ent = self._acquire(block_id, create=False)
        except OSError as e:
            raise StorageError(
                IO_EXCEPTION, f"read {self.block_path(block_id)}: {e}"
            ) from e
        try:
            buf = os.pread(ent.fd, info.length, info.offset)
        except OSError as e:
            raise StorageError(
                IO_EXCEPTION, f"read {self.block_path(block_id)}: {e}"
            ) from e
        finally:
            self._release(ent)
        if len(buf) < info.length:
            # the chunk extends past the written data: zero-fill the tail
            buf = buf + b"\x00" * (info.length - len(buf))
        return np.frombuffer(buf, dtype=np.uint8).copy()

    def block_length(self, block_id: BlockID) -> int:
        """Bytes of the block file on disk (0 when absent): what a raft
        pipeline's commit apply checks the data phase left here."""
        path = self.block_path(block_id)
        return path.stat().st_size if path.exists() else 0

    def delete_block(self, block_id: BlockID) -> None:
        """Drop a block's file and its cached descriptor."""
        with self._lock:
            ent = self._fds.pop(block_id.local_id, None)
            if ent is not None:
                if ent.refs == 0:
                    self._close_entry(ent)
                else:
                    ent.evicted = True  # the last _release closes it
        self.block_path(block_id).unlink(missing_ok=True)

    def fsync_block(self, block_id: BlockID) -> None:
        with self._lock:
            ent = self._fds.get(block_id.local_id)
            if ent is not None:
                ent.refs += 1
        if ent is not None:
            try:
                os.fsync(ent.fd)
            finally:
                self._release(ent)
            return
        path = self.block_path(block_id)
        if path.exists():
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
