"""Datanode: volumes + container set + the chunk/block verbs.

Port of the verbs of `ozone_tpu/storage/datanode.py` that the EC and
replicated writes, their read-back, the scrubber and the SCM use (the
reference's KeyValueHandler verb switch): CreateContainer, WriteChunk,
ReadChunk (with checksum verification), PutBlock, GetBlock, ListBlock,
GetCommittedBlockLength, DeleteBlock, CloseContainer, DeleteContainer,
the single-writer block fence, the container list and report, the
read-error hook the native datapath's `fail` callback calls
(`on_read_error`), and the host full-data scan (`scan_container`) that the device scrubber
(`storage/scrubber.py`) is held against. `mutation_count` moves with
every change a container report shows, so the datanode daemon
(`net/daemons.py`) sends a full report only when something changed. The
scan queue and the volume checker are not ported yet.
"""

from __future__ import annotations

import itertools
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ozone_tpu_torch.storage.container import Container, ContainerSet, HddsVolume
from ozone_tpu_torch.storage.ids import (
    CHECKSUM_MISMATCH,
    CLOSED_CONTAINER_IO,
    BlockData,
    BlockID,
    ChunkInfo,
    ContainerState,
    StorageError,
)
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumError
from ozone_tpu_torch.utils.metrics import MetricsRegistry


class Datanode:
    """One datanode instance over a root directory of volumes."""

    def __init__(self, root: Path, dn_id: str = "dn0", num_volumes: int = 1):
        self.root = Path(root)
        self.id = dn_id
        self.volumes = [
            HddsVolume(self.root / f"vol{i}") for i in range(num_volumes)
        ]
        self.containers = ContainerSet()
        self.metrics = MetricsRegistry(f"datanode.{dn_id}")
        self._rr = itertools.count()
        self._lock = threading.Lock()
        #: bumped by every verb that changes what a container report shows
        self.mutation_count = 0
        for vol in self.volumes:
            for c in vol.load_containers():
                self.containers.add(c)

    # -- container verbs --
    def create_container(
        self,
        container_id: int,
        replica_index: int = 0,
        state: ContainerState = ContainerState.OPEN,
    ) -> Container:
        with self._lock:
            vol = self.volumes[next(self._rr) % len(self.volumes)]
            c = Container(container_id, vol.container_dir(container_id),
                          vol.db, state=state, replica_index=replica_index)
            c.root.mkdir(parents=True, exist_ok=True)
            c.save_descriptor()
            self.containers.add(c)
            self.mutation_count += 1
            self.metrics.counter("container_created").inc()
            return c

    def close_container(self, container_id: int) -> None:
        self.containers.get(container_id).close()
        self.mutation_count += 1
        self.metrics.counter("container_closed").inc()

    def delete_container(self, container_id: int, force: bool = False) -> None:
        """Drop a replica: its block records, chunk files and directory.
        An OPEN container goes only with force (reconstruction cleanup)."""
        c = self.containers.get(container_id)
        if not force and c.state == ContainerState.OPEN:
            raise StorageError(
                CLOSED_CONTAINER_IO, f"container {container_id} is OPEN"
            )
        c.db.delete_container(container_id)
        c.chunks.close()  # release cached block-file descriptors
        shutil.rmtree(c.root, ignore_errors=True)
        self.containers.remove(container_id)
        self.mutation_count += 1
        self.metrics.counter("container_deleted").inc()

    def list_containers(self) -> list[Container]:
        return list(self.containers)

    def scan_container(self, container_id: int) -> list[str]:
        """Full-data scan on the host: verify every chunk checksum (the
        reference's BackgroundContainerDataScanner). Returns error strings
        and marks the container UNHEALTHY if there are any."""
        c = self.containers.get(container_id)
        errors: list[str] = []
        for block in c.list_blocks():
            for info in block.chunks:
                try:
                    data = c.chunks.read_chunk(block.block_id, info)
                    if info.checksum.checksums:
                        Checksum().verify(data, info.checksum)
                except (StorageError, ChecksumError) as e:
                    errors.append(f"{block.block_id}/{info.name}: {e}")
        if errors:
            c.mark_unhealthy()
        self.metrics.counter("containers_scanned").inc()
        return errors

    # -- chunk/block verbs --
    def write_chunk(
        self, block_id: BlockID, info: ChunkInfo, data, sync: bool = False,
        writer: Optional[str] = None,
    ) -> None:
        with self.metrics.histogram("chunk_write_seconds").time():
            c = self.containers.get(block_id.container_id)
            c.require_writable()
            self._fence(c, block_id, writer)
            c.chunks.write_chunk(block_id, info, data, sync=sync)
            self.metrics.counter("bytes_written").inc(info.length)

    def _fence(self, container: Container, block_id: BlockID,
               writer: Optional[str]) -> None:
        """Single-writer block fence (the reference's
        validateChunkForOverwrite); violations are counted."""
        try:
            container.bind_writer(block_id, writer)
        except StorageError:
            self.metrics.counter("write_fence_violations").inc()
            raise

    def read_chunk(
        self, block_id: BlockID, info: ChunkInfo, verify: bool = False
    ) -> np.ndarray:
        with self.metrics.histogram("chunk_read_seconds").time():
            c = self.containers.get(block_id.container_id)
            data = c.chunks.read_chunk(block_id, info)
            if verify and info.checksum.checksums:
                try:
                    Checksum().verify(data, info.checksum,
                                      offset_hint=str(block_id))
                except ChecksumError as e:
                    self.metrics.counter("checksum_failures").inc()
                    self.on_read_error(c)
                    raise StorageError(CHECKSUM_MISMATCH, str(e)) from e
            self.metrics.counter("bytes_read").inc(info.length)
            return data

    def on_read_error(self, container: Container) -> None:
        """A chunk failed its checksum on a read (the RPC verb's check or
        the native datapath's): the container goes UNHEALTHY, and the next
        container report carries it to the SCM, whose replication manager
        rebuilds it (the reference's on-demand scan trigger)."""
        container.mark_unhealthy()
        self.mutation_count += 1

    def put_block(self, block: BlockData, sync: bool = False,
                  writer: Optional[str] = None) -> None:
        c = self.containers.get(block.block_id.container_id)
        c.require_writable()
        # the data path's fence: a foreign writer must not commit its
        # chunk list over a block another writer owns
        self._fence(c, block.block_id, writer)
        if sync:
            c.chunks.fsync_block(block.block_id)
        block.committed = True
        c.put_block(block)
        self.mutation_count += 1
        self.metrics.counter("blocks_committed").inc()

    def get_block(self, block_id: BlockID) -> BlockData:
        return self.containers.get(block_id.container_id).get_block(block_id)

    def list_blocks(self, container_id: int) -> list[BlockData]:
        return self.containers.get(container_id).list_blocks()

    def get_committed_block_length(self, block_id: BlockID) -> int:
        return self.get_block(block_id).length

    def delete_block(self, block_id: BlockID) -> None:
        c = self.containers.get(block_id.container_id)
        c.db.delete_block(block_id)
        c.chunks.delete_block(block_id)
        c.release_writer(block_id)
        self.mutation_count += 1

    def container_report(self) -> list[dict]:
        """Per-container replica report for SCM heartbeats (the reference's
        full container report)."""
        return [
            {
                "container_id": c.id,
                "state": c.state.value,
                "replica_index": c.replica_index,
                "block_count": len(c.list_blocks()),
                "used_bytes": c.used_bytes(),
            }
            for c in self.containers
        ]

    def close(self) -> None:
        for c in self.containers:
            c.chunks.close()
        for v in self.volumes:
            v.close()
