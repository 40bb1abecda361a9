"""Containers and volumes: the datanode storage engine.

Port of `ozone_tpu/storage/container.py` (the reference's KeyValueContainer
model): one sqlite DB per volume holds the block metadata of all its
containers, each container is a directory with a JSON descriptor and
file-per-block chunk files. `HddsVolume(root, readonly=True)` opens a
volume for the offline debug tools: sqlite in mode=ro with no DDL, chunk
files O_RDONLY, nothing created; `load_containers(on_error=...)` reports
a bad descriptor and goes on instead of raising.
"""

from __future__ import annotations

import functools
import json
import logging
import sqlite3
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

from ozone_tpu_torch.storage.chunk_store import FilePerBlockStore
from ozone_tpu_torch.storage.ids import (
    BLOCK_WRITE_CONFLICT,
    CONTAINER_EXISTS,
    CONTAINER_NOT_FOUND,
    INVALID_CONTAINER_STATE,
    NO_SUCH_BLOCK,
    BlockData,
    BlockID,
    ContainerState,
    StorageError,
)

log = logging.getLogger(__name__)


def _guard_sqlite(fn):
    """Surface a failing disk as StorageError(IO_EXCEPTION), the code the
    writers' exclude-and-reallocate handlers key off."""

    @functools.wraps(fn)
    def inner(*a, **kw):
        try:
            return fn(*a, **kw)
        except sqlite3.Error as e:
            raise StorageError("IO_EXCEPTION", f"container db: {e}")

    return inner


class VolumeDB:
    """Per-volume block-metadata store. With readonly=True the sqlite file
    opens in mode=ro and no DDL runs: the offline debug tools inspect a
    failing disk remounted read-only without writing a byte."""

    @_guard_sqlite
    def __init__(self, path: Path, readonly: bool = False):
        self._lock = threading.Lock()
        if readonly:
            self._conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True,
                                         check_same_thread=False)
            return
        self._conn = sqlite3.connect(str(path), check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS blocks ("
            " container_id INTEGER, local_id INTEGER, data TEXT,"
            " PRIMARY KEY (container_id, local_id))"
        )
        # WAL + NORMAL: a committed transaction survives a process crash
        # without an fsync per putBlock, as in `ozone_tpu`
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.commit()

    @_guard_sqlite
    def put_block(self, block: BlockData) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO blocks VALUES (?, ?, ?)",
                (
                    block.block_id.container_id,
                    block.block_id.local_id,
                    json.dumps(block.to_json()),
                ),
            )
            self._conn.commit()

    @_guard_sqlite
    def get_block(self, block_id: BlockID) -> Optional[BlockData]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM blocks WHERE container_id=? AND local_id=?",
                (block_id.container_id, block_id.local_id),
            ).fetchone()
        return BlockData.from_json(json.loads(row[0])) if row else None

    @_guard_sqlite
    def list_blocks(self, container_id: int) -> list[BlockData]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT data FROM blocks WHERE container_id=? ORDER BY local_id",
                (container_id,),
            ).fetchall()
        return [BlockData.from_json(json.loads(r[0])) for r in rows]

    @_guard_sqlite
    def delete_block(self, block_id: BlockID) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM blocks WHERE container_id=? AND local_id=?",
                (block_id.container_id, block_id.local_id),
            )
            self._conn.commit()

    @_guard_sqlite
    def delete_container(self, container_id: int) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM blocks WHERE container_id=?", (container_id,)
            )
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class Container:
    """One container replica on one volume."""

    def __init__(
        self,
        container_id: int,
        root: Path,
        db: VolumeDB,
        state: ContainerState = ContainerState.OPEN,
        replica_index: int = 0,
        readonly: bool = False,
    ):
        self.id = container_id
        self.root = Path(root)
        self.db = db
        self.state = state
        self.replica_index = replica_index
        self.created_at = time.time()
        self.chunks = FilePerBlockStore(self.root / "chunks",
                                        readonly=readonly)
        self._lock = threading.RLock()
        # write fence: the first identified writer of a block file owns it;
        # another writer's stream is refused instead of interleaving bytes
        self._block_writers: dict[int, str] = {}

    def _descriptor_path(self) -> Path:
        return self.root / "container.json"

    def save_descriptor(self) -> None:
        self._descriptor_path().write_text(
            json.dumps(
                {
                    "id": self.id,
                    "state": self.state.value,
                    "replica_index": self.replica_index,
                    "created_at": self.created_at,
                }
            )
        )

    @classmethod
    def load(cls, root: Path, db: VolumeDB,
             readonly: bool = False) -> "Container":
        d = json.loads((Path(root) / "container.json").read_text())
        c = cls(int(d["id"]), root, db, ContainerState(d["state"]),
                int(d.get("replica_index", 0)), readonly=readonly)
        c.created_at = d.get("created_at", c.created_at)
        return c

    # -- state machine --
    def require_writable(self) -> None:
        if self.state not in (ContainerState.OPEN, ContainerState.RECOVERING):
            raise StorageError(
                INVALID_CONTAINER_STATE,
                f"container {self.id} is {self.state.value}, not writable",
            )

    def close(self) -> None:
        with self._lock:
            if self.state in (ContainerState.CLOSED, ContainerState.QUASI_CLOSED):
                return
            if self.state not in (
                ContainerState.OPEN,
                ContainerState.CLOSING,
                ContainerState.RECOVERING,
            ):
                raise StorageError(
                    INVALID_CONTAINER_STATE,
                    f"cannot close container {self.id} in {self.state.value}",
                )
            self.state = ContainerState.CLOSED
            self.save_descriptor()
            self._block_writers.clear()

    def mark_unhealthy(self) -> None:
        with self._lock:
            self.state = ContainerState.UNHEALTHY
            self.save_descriptor()

    def bind_writer(self, block_id: BlockID, writer: Optional[str]) -> None:
        """Enforce single-writer ownership of a block file; writer=None
        (repair and offline tools) bypasses the fence."""
        if writer is None:
            return
        with self._lock:
            cur = self._block_writers.get(block_id.local_id)
            if cur is None:
                self._block_writers[block_id.local_id] = writer
            elif cur != writer:
                raise StorageError(
                    BLOCK_WRITE_CONFLICT,
                    f"{block_id} is being written by {cur!r}; refusing "
                    f"interleaved stream from {writer!r}",
                )

    def release_writer(self, block_id: BlockID) -> None:
        with self._lock:
            self._block_writers.pop(block_id.local_id, None)

    # -- block ops --
    def put_block(self, block: BlockData) -> None:
        self.db.put_block(block)

    def get_block(self, block_id: BlockID) -> BlockData:
        b = self.db.get_block(block_id)
        if b is None:
            raise StorageError(NO_SUCH_BLOCK, str(block_id))
        return b

    def list_blocks(self) -> list[BlockData]:
        return self.db.list_blocks(self.id)

    def used_bytes(self) -> int:
        return sum(b.length for b in self.list_blocks())


class HddsVolume:
    """One storage volume (disk) holding container directories + a VolumeDB."""

    _PROBE = b"ozone-tpu-disk-check"

    def __init__(self, root: Path, readonly: bool = False):
        self.root = Path(root)
        if not readonly:
            (self.root / "containers").mkdir(parents=True, exist_ok=True)
        self.db = VolumeDB(self.root / "metadata.db", readonly=readonly)
        self.readonly = readonly
        #: a failed disk (the volume checker's verdict): no new container
        #: lands here and its replicas left the container set
        self.failed = False

    def check(self) -> bool:
        """Disk health probe (the reference's DiskChecker behind
        StorageVolumeChecker): a small write, read and delete in the volume
        root. An OSError, or a read-back that differs, fails the volume;
        the verdict is sticky."""
        if self.failed:
            return False
        probe = self.root / ".disk-check"
        try:
            probe.write_bytes(self._PROBE)
            ok = probe.read_bytes() == self._PROBE
            probe.unlink()
            if not ok:
                raise OSError("disk probe read-back differs")
            return True
        except OSError:
            log.warning("volume %s failed its disk check", self.root)
            self.failed = True
            return False

    def container_dir(self, container_id: int) -> Path:
        return self.root / "containers" / str(container_id)

    def load_containers(self, on_error=None) -> Iterator[Container]:
        """This volume's containers. With `on_error`, a container that
        fails to load (a truncated descriptor, bad permissions) is reported
        through the callback and skipped (the forensic tools' contract);
        without it the error propagates (a serving datanode must not drop
        replicas silently)."""
        cdir = self.root / "containers"
        if not cdir.is_dir():
            return
        for d in sorted(cdir.iterdir()):
            if not (d / "container.json").exists():
                continue
            if on_error is None:
                yield Container.load(d, self.db, readonly=self.readonly)
                continue
            try:
                yield Container.load(d, self.db, readonly=self.readonly)
            except Exception as e:  # noqa: BLE001 - reported, not fatal
                on_error(f"{d}: bad descriptor: {e}")

    def close(self) -> None:
        self.db.close()


class ContainerSet:
    """All container replicas on one datanode."""

    def __init__(self):
        self._containers: dict[int, Container] = {}
        self._lock = threading.Lock()

    def add(self, c: Container) -> None:
        with self._lock:
            if c.id in self._containers:
                raise StorageError(CONTAINER_EXISTS, str(c.id))
            self._containers[c.id] = c

    def get(self, container_id: int) -> Container:
        c = self._containers.get(container_id)
        if c is None:
            raise StorageError(CONTAINER_NOT_FOUND, str(container_id))
        return c

    def remove(self, container_id: int) -> None:
        with self._lock:
            self._containers.pop(container_id, None)

    def __iter__(self) -> Iterator[Container]:
        return iter(list(self._containers.values()))

    def __len__(self) -> int:
        return len(self._containers)
