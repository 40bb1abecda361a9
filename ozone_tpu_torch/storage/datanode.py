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
(`net/daemons.py`) sends a full report only when something changed.

Volumes: a new container lands on the next healthy volume in turn
(RoundRobinVolumeChoosingPolicy) or, with `volume_policy="capacity"`, on
the least-used one (CapacityVolumeChoosingPolicy). `check_volumes` is
the StorageVolumeChecker sweep: a volume that fails its disk probe is
out for good and its replicas leave the container set, so the next
report shows the loss and the SCM rebuilds them elsewhere;
`healthy_volume_count` rides the heartbeat. A write-fence violation
queues the container for an on-demand scan (`request_scan`), which the
daemon drains (`pop_scan_requests`).
"""

from __future__ import annotations

import itertools
import logging
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ozone_tpu_torch.storage.container import Container, ContainerSet, HddsVolume
from ozone_tpu_torch.storage.ids import (
    CHECKSUM_MISMATCH,
    CLOSED_CONTAINER_IO,
    CONTAINER_EXISTS,
    BlockData,
    BlockID,
    ChunkInfo,
    ContainerState,
    StorageError,
)
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumError
from ozone_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


class Datanode:
    """One datanode instance over a root directory of volumes."""

    def __init__(self, root: Path, dn_id: str = "dn0", num_volumes: int = 1,
                 volume_policy: str = "round-robin"):
        self.root = Path(root)
        self.id = dn_id
        self.volume_policy = volume_policy
        self.volumes = [
            HddsVolume(self.root / f"vol{i}") for i in range(num_volumes)
        ]
        self.containers = ContainerSet()
        self.metrics = MetricsRegistry(f"datanode.{dn_id}")
        self._rr = itertools.count()
        self._lock = threading.Lock()
        #: bumped by every verb that changes what a container report shows
        self.mutation_count = 0
        self._scan_requests: set[int] = set()
        for vol in self.volumes:
            for c in vol.load_containers():
                self.containers.add(c)

    # -- volume choice and health --
    def _volume_used(self, vol: HddsVolume) -> int:
        # volume membership by the shared VolumeDB handle: a path prefix
        # would take vol1 for vol10
        return sum(c.used_bytes() for c in self.containers
                   if c.db is vol.db)

    def _choose_volume(self) -> HddsVolume:
        healthy = [v for v in self.volumes if not v.failed]
        if not healthy:
            raise StorageError("IO_EXCEPTION",
                               f"{self.id}: no healthy volumes left")
        if len(healthy) > 1 and self.volume_policy == "capacity":
            used = {id(v.db): 0 for v in healthy}
            for c in self.containers:
                k = id(c.db)
                if k in used:
                    used[k] += c.used_bytes()
            return min(healthy, key=lambda v: used[id(v.db)])
        return healthy[next(self._rr) % len(healthy)]

    def check_volumes(self) -> list[str]:
        """Probe every volume; drop the replicas of each newly failed one
        from the container set. Returns the roots of the volumes that
        failed in this sweep."""
        newly_failed: list[str] = []
        for vol in self.volumes:
            if vol.failed or vol.check():
                continue
            newly_failed.append(str(vol.root))
            # under create_container's lock: a create that chose this
            # volume before the verdict is in the set and goes here, a
            # later one sees vol.failed
            with self._lock:
                lost = [c for c in self.containers if c.db is vol.db]
                for c in lost:
                    self.containers.remove(c.id)
                self.mutation_count += 1
            self.metrics.counter("volumes_failed").inc()
            log.warning("%s: volume %s failed; dropped %d container "
                        "replicas", self.id, vol.root, len(lost))
        return newly_failed

    @property
    def healthy_volume_count(self) -> int:
        return sum(1 for v in self.volumes if not v.failed)

    # -- container verbs --
    def create_container(
        self,
        container_id: int,
        replica_index: int = 0,
        state: ContainerState = ContainerState.OPEN,
    ) -> Container:
        with self._lock:
            # refuse before touching a disk: a descriptor written for a
            # container already held (on another volume) would load as a
            # second copy of it at the next start
            if container_id in {x.id for x in self.containers}:
                raise StorageError(CONTAINER_EXISTS, str(container_id))
            vol = self._choose_volume()
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

    def get_container(self, container_id: int) -> Container:
        return self.containers.get(container_id)

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
        validateChunkForOverwrite). A violation is counted and queues the
        container for an on-demand scan (OnDemandContainerDataScanner)."""
        try:
            container.bind_writer(block_id, writer)
        except StorageError:
            self.metrics.counter("write_fence_violations").inc()
            self.request_scan(container.id)
            raise

    # -- the on-demand scan queue, drained by the daemon --
    def request_scan(self, container_id: int) -> None:
        with self._lock:
            self._scan_requests.add(int(container_id))

    def pop_scan_requests(self) -> list[int]:
        with self._lock:
            out = sorted(self._scan_requests)
            self._scan_requests.clear()
            return out

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
