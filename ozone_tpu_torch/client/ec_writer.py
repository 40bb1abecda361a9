"""EC key write pipeline: cell accumulation -> batched device encode ->
striped chunk writes -> run commit with rollback.

Port of `ozone_tpu/client/ec_writer.py`. Semantics are the reference's
ECKeyOutputStream: 1 MiB cells round-robin striped over k data blocks,
short final cells zero-padded for parity but written at true length,
parity cells always full, commits carrying the block-group length, and on
failure: finalize the group at the last acked stripe, exclude the failed
nodes, allocate a fresh group and replay there.

Complete stripes queue up and are encoded (and CRC'd) by the fused kernel
`stripe_batch` stripes at a time, staged in pinned host memory. By
default a batch is submitted to the shared codec service
(`codec/service.py`) at width `stripe_batch`, where stripes of concurrent
PUTs coalesce into one launch; a partial final batch is marked as a tail
and rides the service's linger. With OZONE_TPU_CODEC_SERVICE=0 each batch
is one launch of its own, and its parity and CRCs come back with a
non-blocking copy. Either way the batch's results are waited for only
when it is written, so batch N's chunk writes overlap batch N+1's encode.
Each run of stripes bound for one group travels as one WriteChunksCommit
per unit: all the run's chunks plus the commit. With batched_rpc=False
(or OZONE_TPU_BATCH_WRITES=0), and for good once a member refuses the
batched verb (a protocol downgrade, not a device fallback), each stripe
is written on its own: k+p WriteChunk calls, then a PutBlock barrier on
every unit, whose order defines the ack watermark (the reference's
flushStripeFromQueue). Each member's refusal of the batched verb counts
once in the `ec.writer` registry's `batch_downgrades`.
"""

from __future__ import annotations

import inspect
import logging
import os
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import (
    DatanodeClientFactory,
    batch_unsupported,
    register_tokens,
)
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.codec import service as codec_service
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import (
    FusedSpec,
    effective_bpc,
    make_fused_encoder,
    resolve_device,
)
from ozone_tpu_torch.codec.pipeline import finish_pull, host_buffer, start_pull
from ozone_tpu_torch.scm.pipeline import Pipeline
from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumData, ChecksumType
from ozone_tpu_torch.utils.metrics import registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)


@dataclass
class BlockGroup:
    """One logical EC block: the same (container_id, local_id) on each of
    the pipeline's k+p nodes, node i holding replica index i+1."""

    container_id: int
    local_id: int
    pipeline: Pipeline
    length: int = 0  # committed user bytes in this group
    #: short-lived capability tokens riding an allocation or a lookup
    #: (the reference's AllocatedBlock token); never stored: the OM
    #: mints fresh READ tokens at each lookup
    token: Optional[dict] = None
    container_token: Optional[dict] = None

    @property
    def block_id(self) -> BlockID:
        return BlockID(self.container_id, self.local_id)

    def to_json(self, with_tokens: bool = False) -> dict:
        """The group as the OM stores it in a key row (the reference's
        fields, so either package reads the other's rows); with its
        tokens on the wire of an allocation."""
        out = {
            "container_id": self.container_id,
            "local_id": self.local_id,
            "length": self.length,
            "nodes": self.pipeline.nodes,
            "replication": str(self.pipeline.replication),
            "pipeline_id": self.pipeline.id,
        }
        if with_tokens:
            if self.token is not None:
                out["token"] = self.token
            if self.container_token is not None:
                out["container_token"] = self.container_token
        return out

    @classmethod
    def from_json(cls, g: dict) -> "BlockGroup":
        from ozone_tpu_torch.scm.pipeline import ReplicationConfig

        kw = {}
        if g.get("pipeline_id") is not None:
            kw["id"] = int(g["pipeline_id"])
        return cls(
            container_id=g["container_id"],
            local_id=g["local_id"],
            pipeline=Pipeline(ReplicationConfig.parse(g["replication"]),
                              list(g["nodes"]), **kw),
            length=g.get("length", 0),
            token=g.get("token"),
            container_token=g.get("container_token"),
        )


class _StreamUnsupported(Exception):
    """A member refused WriteChunksCommit; the run rolled back cleanly."""


class StripeWriteError(Exception):
    def __init__(self, failed_nodes: list[str], cause: Exception):
        super().__init__(f"stripe write failed on {failed_nodes}: {cause}")
        self.failed_nodes = failed_nodes
        self.cause = cause


def call_allocate(allocate_group, excluded, excluded_containers):
    """Invoke an allocation callback, passing the excluded-container list
    only when the callback accepts a second argument."""
    try:
        two_arg = len(inspect.signature(allocate_group).parameters) >= 2
    except (ValueError, TypeError):  # builtins/partials without a signature
        two_arg = False
    if two_arg:
        return allocate_group(excluded, excluded_containers)
    return allocate_group(excluded)


def create_group_containers(clients, group: BlockGroup,
                            replica_indexed: bool) -> None:
    """Create the group's container on every member, replica-indexed (EC:
    member i holds index i+1) or not (replicated), collecting unreachable
    members into one StripeWriteError so the retry path excludes them and
    reallocates."""
    register_tokens(clients, [group])  # the tokens rode the allocation
    health = getattr(clients, "health", None)
    failed: list[str] = []
    cause: Optional[Exception] = None
    for i, dn_id in enumerate(group.pipeline.nodes):
        try:
            client = clients.get(dn_id)
            if replica_indexed:
                client.create_container(group.container_id,
                                        replica_index=i + 1)
            else:
                client.create_container(group.container_id)
        except StorageError as e:
            if e.code != "CONTAINER_EXISTS":
                failed.append(dn_id)
                cause = e
                if health is not None and resilience.is_transport_fault(e):
                    health.failure(dn_id)
        except (KeyError, OSError) as e:
            failed.append(dn_id)
            cause = e
            if health is not None:
                health.failure(dn_id)
    if failed:
        raise StripeWriteError(failed, cause)


def cell_lengths(group_length: int, stripe: int, k: int, cell: int) -> list[int]:
    """User-data length of each of the k data cells of stripe `stripe`."""
    start = stripe * k * cell
    return [max(0, min(cell, group_length - (start + i * cell)))
            for i in range(k)]


def block_lengths(group_length: int, k: int, cell: int) -> list[int]:
    """User-data length of each of the k data blocks of a group."""
    full, rem = divmod(group_length, k * cell)
    return [full * cell + min(cell, max(0, rem - i * cell)) for i in range(k)]


@dataclass
class _Stripe:
    data: np.ndarray  # [k, C] zero-padded
    lengths: list[int]  # true user-data length per cell
    index: int = -1  # stripe index within its group, assigned at write time


class ECKeyWriter:
    """Writes one key's byte stream as EC block groups.

    allocate_group(excluded_nodes[, excluded_containers]) -> BlockGroup is
    the allocation callback; close() returns the committed groups with
    their final lengths. The encode runs on `device`: "cuda" launches the
    fused kernel (and raises when CUDA is absent), "cpu" runs its plain
    version. `qos_class` is the codec service's scheduling class of this
    writer's batches.
    """

    def __init__(
        self,
        options: CoderOptions,
        allocate_group: Callable[..., BlockGroup],
        clients: DatanodeClientFactory,
        block_size: int = 16 * 1024 * 1024,
        checksum: ChecksumType = ChecksumType.CRC32C,
        bytes_per_checksum: int = 16 * 1024,
        stripe_batch: int = 8,
        max_retries: int = 3,
        device="cuda",
        qos_class: str = "interactive",
        batched_rpc: Optional[bool] = None,
    ):
        self.opts = options
        self.k, self.p, self.cell = (
            options.data_units,
            options.parity_units,
            options.cell_size,
        )
        if block_size % self.cell:
            raise ValueError("block_size must be a multiple of cell_size")
        self.block_size = block_size
        self.stripes_per_group = block_size // self.cell
        self.allocate_group = allocate_group
        self.clients = clients
        self.checksum_type = checksum
        self.bpc = effective_bpc(self.cell, bytes_per_checksum)
        self.stripe_batch = stripe_batch
        self.max_retries = max_retries
        self.device = resolve_device(device)
        self._spec = FusedSpec(options, checksum, self.bpc)
        self._fused = make_fused_encoder(self._spec, device=self.device)
        self._host_checksum = Checksum(checksum, self.bpc)
        self._qos = qos_class
        #: encode batches submitted: one fused launch each on the direct
        #: route; on the service route they coalesce, so launches are the
        #: service's dispatches
        self.dispatches = 0

        self._groups: list[BlockGroup] = []
        self._group: Optional[BlockGroup] = None
        self._group_chunks: list[list[ChunkInfo]] = []  # per unit
        # datanode write-fence identity, one per logical key write
        self._writer_id = uuid.uuid4().hex
        self._excluded: list[str] = []
        self._excluded_containers: list[int] = []
        # batched WriteChunksCommit streams (one per unit per run) unless
        # disabled; off for good once a member refuses the verb
        if batched_rpc is None:
            batched_rpc = os.environ.get("OZONE_TPU_BATCH_WRITES", "1") != "0"
        self._stream_writes = batched_rpc
        #: shared per-peer health: reallocation skips breaker-open peers
        self._health = getattr(clients, "health", None) \
            or resilience.default_registry()
        #: operation deadline, re-activated on RPC-pool worker threads
        self._deadline: Optional[resilience.Deadline] = resilience.current()

        self._buf = np.zeros((self.k, self.cell), dtype=np.uint8)
        self._cell_idx = 0
        self._cell_off = 0
        self._queue: list[_Stripe] = []
        self._stripe_in_group = 0
        self._closed = False
        # one worker per unit stream: the k+p unit writes of a run go out
        # concurrently
        self._rpc_pool: Optional[ThreadPoolExecutor] = None
        # the batch in flight: (stripes, the service's future or
        # start_pull's copies and event)
        self._pending: Optional[tuple] = None

    # ------------------------------------------------------------------ write
    def write(self, data) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        d = resilience.current()
        if d is not None:
            self._deadline = d  # freshest ambient budget wins
        arr = hostmem.as_array(data)
        pos = 0
        while pos < arr.size:
            take = min(self.cell - self._cell_off, arr.size - pos)
            self._buf[self._cell_idx, self._cell_off : self._cell_off + take] = (
                arr[pos : pos + take]
            )
            self._cell_off += take
            pos += take
            if self._cell_off == self.cell:
                self._cell_off = 0
                self._cell_idx += 1
                if self._cell_idx == self.k:
                    self._enqueue_full_stripe()

    def _enqueue_full_stripe(self) -> None:
        self._queue.append(_Stripe(self._buf, [self.cell] * self.k))
        self._buf = np.zeros((self.k, self.cell), dtype=np.uint8)
        self._cell_idx = 0
        if len(self._queue) >= self.stripe_batch:
            self._flush_queue()

    # ------------------------------------------------------------------ flush
    def _flush_queue(self) -> None:
        """Encode all queued stripes as one batch; the batch goes in
        flight and the previous in-flight batch is written now."""
        if not self._queue:
            return
        stripes, self._queue = self._queue, []
        staged = self._stage(stripes)
        svc = codec_service.maybe_service()
        if svc is not None:
            # a partial batch (the tail of a small PUT) rides the linger
            # to share its launch with other operations' stripes
            pending = (stripes, svc.submit(
                codec_service.encode_key(self._spec), self._fused, staged,
                width=self.stripe_batch, qos=self._qos,
                tail=len(stripes) < self.stripe_batch,
                deadline=self._deadline))
        else:
            with Tracer.instance().span("codec:device_dispatch",
                                        rows=len(stripes),
                                        width=self.stripe_batch, direct=True):
                pending = (stripes, start_pull(self._fused(staged)))
        self.dispatches += 1
        prev, self._pending = self._pending, pending
        if prev is not None:
            self._write_batch(*self._resolve_pending(prev))

    def _stage(self, stripes: list[_Stripe]) -> torch.Tensor:
        """The batch [B, k, C] on the host, pinned when it goes to CUDA."""
        host = host_buffer((len(stripes), self.k, self.cell), self.device)
        np.stack([s.data for s in stripes], out=host.numpy())
        return host

    @staticmethod
    def _resolve_pending(prev: tuple) -> tuple:
        """(stripes, parity uint8 [B, p, C], crcs uint32 [B, k+p, S]) of an
        in-flight batch as numpy, once the service has resolved it or its
        copy to the host is done."""
        stripes, pending = prev
        if isinstance(pending, Future):
            return (stripes, *codec_service.wait_result(pending))
        return (stripes, *finish_pull(pending))

    def _drain_pending(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._write_batch(*self._resolve_pending(prev))

    def _write_batch(self, stripes, parity: np.ndarray, crcs: np.ndarray) -> None:
        """Write one encoded batch as runs of stripes, each run the longest
        that fits the current group, replaying a failed run into a fresh
        group."""
        with Tracer.instance().span("ec:flush", stripes=len(stripes)):
            b = 0
            while b < len(stripes):
                if not self._stream_writes:
                    self._write_stripe_retrying(stripes[b], parity[b],
                                                crcs[b])
                    b += 1
                    continue
                if self._group is not None and \
                        self._stripe_in_group >= self.stripes_per_group:
                    self._finalize_group()
                for attempt in range(self.max_retries + 1):
                    try:
                        self._ensure_group()
                        n = min(len(stripes) - b,
                                self.stripes_per_group - self._stripe_in_group)
                        self._write_stripe_run(
                            stripes[b:b + n], parity[b:b + n], crcs[b:b + n])
                        b += n
                        break
                    except _StreamUnsupported:
                        # a member without the verb: replay per stripe
                        # from here on
                        log.info("WriteChunksCommit refused; writing per "
                                 "stripe from here on")
                        self._stream_writes = False
                        break
                    except StripeWriteError as e:
                        log.warning("stripe run at %d failed (attempt %d): %s",
                                    b, attempt, e)
                        if attempt == self.max_retries:
                            raise
                        self._excluded.extend(e.failed_nodes)
                        self._finalize_group()

    def _write_stripe_run(self, run, parity, crcs) -> None:
        """Write `run` as one WriteChunksCommit per unit: every stripe's
        cell as a chunk, the run-end commit piggybacked. On failure, units
        whose stream committed roll back to the pre-run record, so no
        datanode reports bytes the client never acked, and the run replays
        into a fresh group."""
        group = self._group
        for j, s in enumerate(run):
            s.index = self._stripe_in_group + j
        pre_chunks = [list(c) for c in self._group_chunks]
        pre_len = group.length
        len_after = pre_len + sum(sum(s.lengths) for s in run)

        unit_chunks: list[list[tuple[ChunkInfo, np.ndarray]]] = [
            [] for _ in range(self.k + self.p)]
        for j, stripe in enumerate(run):
            for u in range(self.k + self.p):
                is_data = u < self.k
                length = stripe.lengths[u] if is_data else self.cell
                if length == 0:
                    continue
                cell_data = (stripe.data[u] if is_data
                             else parity[j][u - self.k])
                info = ChunkInfo(
                    name=f"{group.block_id}_chunk_{stripe.index}",
                    offset=stripe.index * self.cell,
                    length=length,
                    checksum=self._chunk_checksum(
                        crcs[j][u], length, cell_data),
                )
                unit_chunks[u].append((info, cell_data[:length]))

        def write_unit(u: int):
            new = unit_chunks[u]
            if not new and not pre_chunks[u]:
                return u, None  # nothing written, nothing to re-commit
            bd = BlockData(
                group.block_id,
                pre_chunks[u] + [info for info, _ in new],
                block_group_length=len_after,
            )
            dn_id = group.pipeline.nodes[u]
            try:
                client = self.clients.get(dn_id)
                if new:
                    fn = getattr(client, "write_chunks_commit", None)
                    if fn is None:  # a duck-typed client without the verb
                        return u, StorageError(
                            "IO_EXCEPTION",
                            "UNIMPLEMENTED: client lacks write_chunks_commit")
                    self._observed(dn_id, fn, group.block_id, new,
                                   commit=bd, writer=self._writer_id)
                else:
                    # no new bytes on this unit (short final stripes):
                    # just advance its committed group length
                    self._observed(dn_id, client.put_block, bd,
                                   writer=self._writer_id)
                return u, None
            except (StorageError, KeyError, OSError) as e:
                if isinstance(e, StorageError) \
                        and e.code == resilience.DEADLINE_EXCEEDED:
                    raise  # op budget spent: abort, don't exclude peers
                return u, e

        failed: list[str] = []
        closed = unsupported = False
        cause: Optional[Exception] = None
        ok_units: list[int] = []
        for u, err in self._ensure_pool().map(self._act(write_unit),
                                              range(self.k + self.p)):
            if err is None:
                ok_units.append(u)
            elif batch_unsupported(err):
                unsupported = True
                cause = err
                registry("ec.writer").counter("batch_downgrades").inc()
            elif isinstance(err, StorageError) \
                    and err.code == "INVALID_CONTAINER_STATE":
                # container closed under us: a reallocation signal, not a
                # node fault
                closed = True
                cause = err
                self._excluded_containers.append(group.container_id)
            else:
                failed.append(group.pipeline.nodes[u])
                cause = err
        if not failed and not closed and not unsupported:
            for u in range(self.k + self.p):
                self._group_chunks[u] = pre_chunks[u] + [
                    info for info, _ in unit_chunks[u]]
            group.length = len_after
            self._stripe_in_group += len(run)
            return

        # best-effort rollback: a unit with no prior record stays orphaned
        # in a group that finalizes below its data
        def roll(entry):
            dn_id, bd = entry
            try:
                self.clients.get(dn_id).put_block(bd, writer=self._writer_id)
                return None
            except (StorageError, KeyError, OSError) as e:
                return dn_id, e

        rollbacks = [
            (group.pipeline.nodes[u],
             BlockData(group.block_id, pre_chunks[u],
                       block_group_length=pre_len))
            for u in ok_units if pre_chunks[u]
        ]
        for res in self._ensure_pool().map(self._act(roll), rollbacks):
            if res is not None:
                log.warning("putBlock rollback failed on %s: %s",
                            res[0], res[1])
        if unsupported:
            raise _StreamUnsupported()
        raise StripeWriteError(failed, cause)

    def _write_stripe_retrying(self, stripe: _Stripe, parity: np.ndarray,
                               crcs: np.ndarray) -> None:
        """The per-stripe path with its retries: a failed stripe finalizes
        the group at its committed length and replays into a fresh one."""
        for attempt in range(self.max_retries + 1):
            try:
                self._write_stripe(stripe, parity, crcs)
                return
            except StripeWriteError as e:
                log.warning("stripe %d failed (attempt %d): %s",
                            stripe.index, attempt, e)
                if attempt == self.max_retries:
                    raise
                self._excluded.extend(e.failed_nodes)
                self._finalize_group()

    def _write_stripe(self, stripe: _Stripe, parity: np.ndarray,
                      crcs: np.ndarray) -> None:
        """One stripe: its k+p chunk writes in parallel, then a PutBlock
        barrier on every unit that holds chunks. A failed barrier rolls the
        survivors back to the pre-stripe record, so no datanode reports
        bytes the client never acked."""
        if self._group is not None and \
                self._stripe_in_group >= self.stripes_per_group:
            self._finalize_group()
        group = self._ensure_group()
        stripe.index = self._stripe_in_group
        new_chunks: list[Optional[ChunkInfo]] = [None] * (self.k + self.p)

        def write_unit(u: int):
            is_data = u < self.k
            length = stripe.lengths[u] if is_data else self.cell
            if length == 0:
                return u, None, None
            cell_data = stripe.data[u] if is_data else parity[u - self.k]
            info = ChunkInfo(
                name=f"{group.block_id}_chunk_{stripe.index}",
                offset=stripe.index * self.cell,
                length=length,
                checksum=self._chunk_checksum(crcs[u], length, cell_data),
            )
            dn_id = group.pipeline.nodes[u]
            try:
                self._observed(dn_id, self.clients.get(dn_id).write_chunk,
                               group.block_id, info, cell_data[:length],
                               writer=self._writer_id)
                return u, info, None
            except (StorageError, KeyError, OSError) as e:
                if isinstance(e, StorageError) \
                        and e.code == resilience.DEADLINE_EXCEEDED:
                    raise  # op budget spent: abort, don't exclude peers
                return u, None, e

        failed: list[str] = []
        closed = False
        cause: Optional[Exception] = None
        for u, info, err in self._ensure_pool().map(
                self._act(write_unit), range(self.k + self.p)):
            if info is not None:
                new_chunks[u] = info
            elif err is not None:
                cause = err
                if isinstance(err, StorageError) \
                        and err.code == "INVALID_CONTAINER_STATE":
                    # container closed under us: reallocate, never
                    # blacklist the pipeline
                    closed = True
                    self._excluded_containers.append(group.container_id)
                else:
                    failed.append(group.pipeline.nodes[u])
        if failed or closed:
            raise StripeWriteError(failed, cause)

        # the stripe barrier: PutBlock on every unit holding chunks
        len_after = group.length + sum(stripe.lengths)
        pre_chunks = [list(c) for c in self._group_chunks]
        puts: list[tuple[str, BlockData]] = []
        for u in range(self.k + self.p):
            chunks = pre_chunks[u] + ([new_chunks[u]] if new_chunks[u]
                                      else [])
            if chunks:
                puts.append((group.pipeline.nodes[u], BlockData(
                    group.block_id, chunks, block_group_length=len_after)))

        def put_unit(entry):
            dn_id, bd = entry
            try:
                self._observed(dn_id, self.clients.get(dn_id).put_block,
                               bd, writer=self._writer_id)
                return None
            except (StorageError, KeyError, OSError) as e:
                return dn_id, e

        errors = [r for r in self._ensure_pool().map(self._act(put_unit),
                                                      puts) if r is not None]
        if errors:
            if all(isinstance(e, StorageError)
                   and e.code == "INVALID_CONTAINER_STATE"
                   for _, e in errors):
                # closed between the chunks and the barrier: reallocate
                self._excluded_containers.append(group.container_id)
                raise StripeWriteError([], errors[0][1])
            failed_dns = {dn_id for dn_id, _ in errors}
            rollbacks = [
                (group.pipeline.nodes[u], BlockData(
                    group.block_id, pre_chunks[u],
                    block_group_length=group.length))
                for u in range(self.k + self.p)
                if pre_chunks[u]
                and group.pipeline.nodes[u] not in failed_dns]
            for res in self._ensure_pool().map(self._act(put_unit),
                                               rollbacks):
                if res is not None:
                    log.warning("putBlock rollback failed on %s: %s",
                                res[0], res[1])
            bad = [d for d, e in errors
                   if not (isinstance(e, StorageError)
                           and e.code == "INVALID_CONTAINER_STATE")]
            raise StripeWriteError(bad, errors[0][1])
        for u in range(self.k + self.p):
            if new_chunks[u] is not None:
                self._group_chunks[u].append(new_chunks[u])
        group.length = len_after
        self._stripe_in_group += 1

    def _chunk_checksum(self, device_crcs: np.ndarray, length: int,
                        cell_data: np.ndarray) -> ChecksumData:
        """ChecksumData for one written chunk: the device CRCs for a full
        cell, a host computation for a partial one."""
        if self.checksum_type is ChecksumType.NONE:
            return ChecksumData(self.checksum_type, self.bpc)
        if length == self.cell and self.cell % self.bpc == 0:
            sums = tuple(
                int(v).to_bytes(4, "big") for v in device_crcs.tolist()
            )
            return ChecksumData(self.checksum_type, self.bpc, sums)
        return self._host_checksum.compute(cell_data[:length])

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._rpc_pool is None:
            self._rpc_pool = ThreadPoolExecutor(
                max_workers=self.k + self.p,
                thread_name_prefix="ec-writer")
        return self._rpc_pool

    def _act(self, fn):
        """Wrap a pool callable so the operation deadline is ambient on
        the worker thread."""
        d = self._deadline
        if d is None:
            return fn

        def wrapped(*a):
            with resilience.activate(d):
                return fn(*a)

        return wrapped

    def _observed(self, dn_id: str, fn, *a, **kw):
        """Health-recording RPC, one span per hop."""
        with Tracer.instance().span(
                f"net:{getattr(fn, '__name__', 'rpc')}", dn=dn_id):
            return self._health.observe(dn_id, fn, *a, **kw)

    # ------------------------------------------------------------------ groups
    def _ensure_group(self) -> BlockGroup:
        if self._group is None:
            excluded = list(self._excluded)
            # a peer whose breaker is open is excluded up front
            extra = [dn for dn in self._health.open_peers()
                     if dn not in excluded]
            try:
                self._group = call_allocate(
                    self.allocate_group, excluded + extra,
                    tuple(self._excluded_containers))
            except Exception as e:  # the breaker exclusion is advisory
                if not extra or (isinstance(e, StorageError)
                                 and e.code == resilience.DEADLINE_EXCEEDED):
                    raise
                log.warning(
                    "allocation with breaker-open peers %s excluded "
                    "failed (%s); retrying without the advisory "
                    "exclusions", extra, e)
                self._group = call_allocate(
                    self.allocate_group, excluded,
                    tuple(self._excluded_containers))
            self._group_chunks = [[] for _ in range(self.k + self.p)]
            try:
                create_group_containers(self.clients, self._group,
                                        replica_indexed=True)
            except StripeWriteError:
                # discard the group before any data hits it
                self._group = None
                raise
        return self._group

    def _finalize_group(self) -> None:
        if self._group is not None and self._group.length > 0:
            self._groups.append(self._group)
        self._group = None
        self._group_chunks = []
        self._stripe_in_group = 0

    def hsync(self) -> list[BlockGroup]:
        """EC keys do not support hsync (a partial stripe cannot be made
        durable without writing throwaway parity)."""
        raise StorageError("NOT_SUPPORTED_OPERATION",
                           "hsync is not supported for EC keys")

    # ------------------------------------------------------------------ close
    def close(self) -> list[BlockGroup]:
        """Flush the final (possibly partial) stripe and return the
        committed block groups in key order."""
        if self._closed:
            return self._groups
        d = resilience.current()
        if d is not None:
            self._deadline = d
        try:
            # partial stripe: pad for parity, write true lengths
            if self._cell_idx > 0 or self._cell_off > 0:
                lengths = [
                    self.cell if i < self._cell_idx
                    else (self._cell_off if i == self._cell_idx else 0)
                    for i in range(self.k)
                ]
                self._queue.append(_Stripe(self._buf, lengths))
                self._buf = np.zeros((self.k, self.cell), dtype=np.uint8)
                self._cell_idx = 0
                self._cell_off = 0
            self._flush_queue()
            self._drain_pending()  # the last in-flight encoded batch
            self._finalize_group()
            self._closed = True
        finally:
            if self._rpc_pool is not None:
                self._rpc_pool.shutdown(wait=True)
                self._rpc_pool = None
        return self._groups

    @property
    def bytes_written(self) -> int:
        done = sum(g.length for g in self._groups)
        cur = self._group.length if self._group else 0
        queued = sum(sum(s.lengths) for s in self._queue)
        inflight = (sum(sum(s.lengths) for s in self._pending[0])
                    if self._pending is not None else 0)
        partial = self._cell_idx * self.cell + self._cell_off
        return done + cur + queued + inflight + partial
