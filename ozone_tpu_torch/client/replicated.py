"""Replicated (non-EC) key write and read path.

Port of `ozone_tpu/client/replicated.py` (the reference's KeyOutputStream
-> BlockOutputStream over a replicated pipeline): every chunk goes to all
replicas of the pipeline, one combined chunk-write-and-commit per member
(the put-block piggyback), with a rollback of the members that took it
when another member fails; reads fail over and hedge between replicas.
The reference's downgrade to split chunk-write and put-block calls, for
remote peers without the combined verb, waits for the remote transport.
Chunk checksums are the host CRC32C (`utils/checksum.py`, the native
library when it is built). The Raft-ordered writer is not ported: the
port's OzoneClient writes every replicated key through this one.
"""

from __future__ import annotations

import logging
import uuid
from typing import Callable, Optional

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ec_writer import (
    BlockGroup,
    StripeWriteError,
    call_allocate,
    create_group_containers,
)
from ozone_tpu_torch.storage.ids import BlockData, ChunkInfo, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

log = logging.getLogger(__name__)


class ReplicatedKeyWriter:
    """Writes a key as replicated blocks: chunks fanned to every pipeline
    node, a block commit with each chunk."""

    def __init__(
        self,
        allocate_group: Callable[[list[str]], BlockGroup],
        clients: DatanodeClientFactory,
        block_size: int = 16 * 1024 * 1024,
        chunk_size: int = 4 * 1024 * 1024,
        checksum: ChecksumType = ChecksumType.CRC32C,
        bytes_per_checksum: int = 16 * 1024,
        max_retries: int = 3,
    ):
        self.allocate_group = allocate_group
        self.clients = clients
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.checksum = Checksum(checksum, bytes_per_checksum)
        self.max_retries = max_retries
        self._groups: list[BlockGroup] = []
        self._group: Optional[BlockGroup] = None
        self._chunks: list[ChunkInfo] = []
        self._buf = np.zeros(chunk_size, dtype=np.uint8)
        self._buf_fill = 0
        self._excluded: list[str] = []
        #: containers seen CLOSED mid-write: the SCM may offer them again
        #: until their report lands, so exclusion rides the allocation
        self._excluded_containers: list[int] = []
        self._closed = False
        # datanode write-fence identity, one per logical key write
        self._writer_id = uuid.uuid4().hex

    def write(self, data) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        arr = np.asarray(
            np.frombuffer(data, dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else data,
            dtype=np.uint8,
        ).reshape(-1)
        pos = 0
        while pos < arr.size:
            take = min(self.chunk_size - self._buf_fill, arr.size - pos)
            self._buf[self._buf_fill:self._buf_fill + take] = \
                arr[pos:pos + take]
            self._buf_fill += take
            pos += take
            if self._buf_fill == self.chunk_size:
                self._flush_chunk()

    def _ensure_group(self) -> BlockGroup:
        if self._group is None:
            self._group = call_allocate(
                self.allocate_group, list(self._excluded),
                tuple(self._excluded_containers))
            self._chunks = []
            try:
                create_group_containers(self.clients, self._group,
                                        replica_indexed=False)
            except StripeWriteError:
                self._group = None  # the retry allocates without the failed
                raise
        return self._group

    def _flush_chunk(self) -> None:
        if self._buf_fill == 0:
            return
        data = self._buf[:self._buf_fill].copy()
        self._buf_fill = 0
        for attempt in range(self.max_retries + 1):
            try:
                group = self._ensure_group()
                if group.length + data.size > self.block_size:
                    # a rollover allocation takes the same retry handler
                    self._finalize_group()
                    group = self._ensure_group()
            except StripeWriteError as e:
                log.warning("group allocation failed on %s: %s",
                            e.failed_nodes, e.cause)
                self._excluded.extend(e.failed_nodes)
                if attempt == self.max_retries:
                    raise StorageError(
                        "IO_EXCEPTION", f"write failed: {e.cause}")
                continue
            info = ChunkInfo(
                name=f"{group.block_id}_chunk_{len(self._chunks)}",
                offset=group.length,
                length=int(data.size),
                checksum=self.checksum.compute(data),
            )
            ok, failed, closed, err = self._write_and_commit(
                group, info, data)
            if ok:
                self._chunks.append(info)
                group.length += data.size
                return
            log.warning("chunk write failed on %s: %s", failed or "commit",
                        err)
            self._excluded.extend(failed)
            self._finalize_group()
            if attempt == self.max_retries:
                raise StorageError("IO_EXCEPTION", f"write failed: {err}")

    def _write_and_commit(self, group: BlockGroup, info: ChunkInfo,
                          data) -> tuple:
        """Data fan-out and block commit of one chunk, one combined call per
        member (every port datanode client serves it). On a partial
        failure the members that took the call roll back to the pre-chunk
        record, so replicas never disagree on committed length. Returns
        (ok, failed_nodes, container_closed, error)."""
        failed: list[str] = []
        ok_nodes: list[str] = []
        closed = False
        err: Optional[Exception] = None
        bd = BlockData(group.block_id, [*self._chunks, info])
        for dn_id in group.pipeline.nodes:
            try:
                self.clients.get(dn_id).write_chunks_commit(
                    group.block_id, [(info, data)], commit=bd,
                    writer=self._writer_id)
                ok_nodes.append(dn_id)
            except StorageError as e:
                err = e
                if e.code == "INVALID_CONTAINER_STATE":
                    # closed under us: reallocate without excluding a
                    # healthy node, but never take this container again
                    closed = True
                    self._excluded_containers.append(group.container_id)
                else:
                    failed.append(dn_id)
            except (KeyError, OSError) as e:
                failed.append(dn_id)
                err = e
        ok = not failed and not closed
        if not ok:
            self._rollback(group, ok_nodes)
        return ok, failed, closed, err

    def _rollback(self, group: BlockGroup,
                           ok_nodes: list[str]) -> None:
        """Best-effort return of the members that took the chunk to the
        pre-chunk record; a member with no prior record keeps its orphan
        in a group that finalizes below it."""
        if not ok_nodes or not self._chunks:
            return
        prev = BlockData(group.block_id, list(self._chunks))
        for dn_id in ok_nodes:
            try:
                self.clients.get(dn_id).put_block(
                    prev, writer=self._writer_id)
            except (StorageError, KeyError, OSError) as e:
                log.warning("putBlock rollback failed on %s: %s",
                            dn_id, e)

    def _finalize_group(self) -> None:
        if self._group is not None and self._group.length > 0:
            self._groups.append(self._group)
        self._group = None
        self._chunks = []

    def close(self) -> list[BlockGroup]:
        if self._closed:
            return self._groups
        self._flush_chunk()
        self._finalize_group()
        self._closed = True
        return self._groups

    @property
    def bytes_written(self) -> int:
        done = sum(g.length for g in self._groups)
        cur = self._group.length if self._group else 0
        return done + cur + self._buf_fill


class ReplicatedKeyReader:
    """Reads replicated blocks with replica failover and hedging: the
    first usable replica is read first; once it exceeds its latency
    estimate (or the OZONE_TPU_HEDGE_MS floor) the same read fires at the
    next replica, and the first result wins. Replicas whose breaker is
    open go to the back of the chain. Each datanode checks the stored
    chunk CRCs of what it serves unless `verify` is off."""

    def __init__(self, group: BlockGroup, clients: DatanodeClientFactory,
                 verify: bool = True):
        self.group = group
        self.clients = clients
        self.verify = verify
        self._health = getattr(clients, "health", None) \
            or resilience.default_registry()

    def read_all(self) -> np.ndarray:
        return self.read(0, self.group.length)

    def read(self, offset: int, length: int) -> np.ndarray:
        """Chunk-granular range read: only the chunks overlapping
        [offset, offset+length) are read."""
        if offset < 0 or length < 0 or \
                offset + length > self.group.length:
            raise ValueError("range out of bounds")
        if length == 0:
            return np.zeros(0, np.uint8)
        # non-claiming check: ordering must not consume half-open probes
        nodes = sorted(self.group.pipeline.nodes,
                       key=lambda dn: not self._health.usable(dn))

        def read_from(dn_id):
            return self._health.observe(
                dn_id, self._read_replica, dn_id, offset, length)

        try:
            win = resilience.HedgeGroup().run(
                lambda: read_from(nodes[0]),
                [(lambda dn: lambda: read_from(dn))(dn)
                 for dn in nodes[1:]],
                delay_s=self._health.hedge_delay_s(nodes[0]))
            return win.value
        except (StorageError, KeyError, OSError) as e:
            if isinstance(e, StorageError) \
                    and e.code == resilience.DEADLINE_EXCEEDED:
                # the operation budget ran out, not the replicas
                raise
            raise StorageError("NO_SUCH_BLOCK",
                               f"all replicas failed: {e}")

    def _read_replica(self, dn_id: str, offset: int,
                      length: int) -> np.ndarray:
        """One replica's attempt at the whole range; raises on any
        shortfall so the hedge and failover chain moves on."""
        client = self.clients.get(dn_id)
        bd = client.get_block(self.group.block_id)
        wanted = [c for c in bd.chunks
                  if c.offset < offset + length
                  and c.offset + c.length > offset]
        parts = client.read_chunks(self.group.block_id, wanted, self.verify)
        out = np.zeros(length, dtype=np.uint8)
        covered = 0
        for info, data in zip(wanted, parts):
            a = max(offset, info.offset)
            b = min(offset + length, info.offset + len(data))
            if a < b:
                out[a - offset:b - offset] = \
                    data[a - info.offset:b - info.offset]
                covered += b - a
        if covered != length:
            # a stale or short replica must fail over, not read zeros
            raise StorageError(
                "NO_SUCH_BLOCK",
                f"replica {dn_id} covers {covered}/{length} "
                f"bytes of [{offset},{offset + length})")
        return out
