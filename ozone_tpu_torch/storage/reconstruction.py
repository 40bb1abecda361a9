"""Offline EC reconstruction coordinator.

Port of `ozone_tpu/storage/reconstruction.py` (the reference's
ECReconstructionCoordinator, reconstructECContainerGroup) on its
single-device path. Driven by a ReconstructECContainers command carrying
the source replica-index -> node and target index -> node maps, it

  1. creates RECOVERING containers on the targets,
  2. lists the blocks on every source and takes their union,
  3. per block, recovers the missing units' cells through the reader's
     depth-1 decode pipeline (batch N's recovered chunks go to the
     targets while batch N+1 reads survivors and decodes), with up to
     `max_parallel_blocks` blocks in flight; the reader picks the read
     set (k survivors for RS, the lost unit's local group for an LRC
     single loss) and submits to the shared codec service in its "bulk"
     class unless the service is off,
  4. commits each target's block once every batch has landed, and closes
     the targets,
  5. deletes the RECOVERING containers on any failure.

Recovered chunks carry the CRCs the decode computed on the device.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import (
    DatanodeClientFactory,
    build_chunk_pairs,
    write_unit_stream,
)
from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader, unit_true_lengths
from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import effective_bpc, resolve_device
from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig
from ozone_tpu_torch.storage.ids import (
    BlockData,
    ChunkInfo,
    ContainerState,
    StorageError,
)
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType
from ozone_tpu_torch.utils.metrics import MetricsRegistry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

MISSING_NODE = "__missing__"


@dataclass(frozen=True)
class ReconstructionCommand:
    """SCM -> DN command (ReconstructECContainersCommand analog)."""

    container_id: int
    replication: CoderOptions
    sources: dict[int, str]  # replica index (1-based) -> dn_id
    targets: dict[int, str]  # missing replica index (1-based) -> dn_id


class ECReconstructionCoordinator:
    """Rebuilds lost replicas of EC containers onto new datanodes. The
    decode runs on `device`: "cuda" launches the fused kernel (and raises
    when CUDA is absent), "cpu" runs its plain version."""

    def __init__(
        self,
        clients: DatanodeClientFactory,
        checksum: ChecksumType = ChecksumType.CRC32C,
        bytes_per_checksum: int = 16 * 1024,
        max_parallel_blocks: int = 2,
        device="cuda",
    ):
        self.clients = clients
        self.checksum = checksum
        self.bpc = bytes_per_checksum
        #: blocks of a container repaired at once: each block's
        #: read+decode+write chain is independent, so a small pool overlaps
        #: one block's survivor reads with another's target writes
        self.max_parallel_blocks = max(1, int(max_parallel_blocks))
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry("ec.reconstruction")
        #: shared peer health: source order skips breaker-open peers, and
        #: the reader's survivor choice and hedging ride the same registry
        self.health = getattr(clients, "health", None) \
            or resilience.default_registry()

    def reconstruct_container_group(self, cmd: ReconstructionCommand) -> None:
        # the reconstruction job's boundary: one deadline (opt-in through
        # OZONE_TPU_OP_DEADLINE_S) covers listing, every block and cleanup
        with resilience.start("reconstruction"):
            self._reconstruct_container_group(cmd)

    def _reconstruct_container_group(self,
                                     cmd: ReconstructionCommand) -> None:
        targets = sorted(cmd.targets)
        created: list[tuple[str, int]] = []
        try:
            # RECOVERING containers on the targets
            for idx in targets:
                dn = cmd.targets[idx]
                self.clients.get(dn).create_container(
                    cmd.container_id,
                    replica_index=idx,
                    state=ContainerState.RECOVERING,
                )
                created.append((dn, idx))

            blocks = self._list_blocks(cmd)

            # per block: recover + write + putBlock; any failure fails the
            # group (RECOVERING cleanup below)
            if self.max_parallel_blocks > 1 and len(blocks) > 1:
                with ThreadPoolExecutor(
                        max_workers=self.max_parallel_blocks,
                        thread_name_prefix="ec-recon") as pool:
                    list(pool.map(
                        lambda bd: self._reconstruct_block(cmd, bd, targets),
                        blocks))
            else:
                for bd in blocks:
                    self._reconstruct_block(cmd, bd, targets)

            for idx in targets:
                self.clients.get(cmd.targets[idx]).close_container(
                    cmd.container_id
                )
            self.metrics.counter("groups_reconstructed").inc()
        except Exception:
            # clean up the RECOVERING containers on failure
            for dn, _idx in created:
                try:
                    self.clients.get(dn).delete_container(
                        cmd.container_id, force=True
                    )
                except (StorageError, KeyError, OSError) as e:
                    log.warning("cleanup of %s on %s failed: %s",
                                cmd.container_id, dn, e)
            self.metrics.counter("groups_failed").inc()
            raise

    def _list_blocks(self, cmd: ReconstructionCommand) -> list[BlockData]:
        """The union of every answering source's block list, by local id.
        One source is not enough: a group shorter than a stripe has no
        block on the data units past its length, so their replicas list
        none of its blocks."""
        last_err: Exception | None = None
        answered = False
        merged: dict[int, BlockData] = {}
        # health-ordered: usable, fastest sources first, so each block
        # keeps the record of the first source that has it
        for dn in self.health.preferred(
                [cmd.sources[idx] for idx in sorted(cmd.sources)]):
            try:
                blocks = self.health.observe(
                    dn, self.clients.get(dn).list_blocks, cmd.container_id)
            except (StorageError, KeyError, OSError) as e:
                last_err = e
                continue
            answered = True
            for bd in blocks:
                merged.setdefault(bd.block_id.local_id, bd)
        if not answered:
            raise StorageError(
                "CONTAINER_NOT_FOUND",
                f"no source could list blocks for {cmd.container_id}: {last_err}",
            )
        return [merged[i] for i in sorted(merged)]

    def _group_for(self, cmd: ReconstructionCommand, bd: BlockData) -> BlockGroup:
        """The block-group view from the command's source map; an index
        with no live source gets a node the client factory cannot resolve
        (the reader treats it as unavailable)."""
        opts = cmd.replication
        nodes = [
            cmd.sources.get(i + 1, MISSING_NODE) for i in range(opts.all_units)
        ]
        length = bd.block_group_length
        if length is None:
            raise StorageError(
                "NO_SUCH_BLOCK", f"block {bd.block_id} has no group length"
            )
        return BlockGroup(
            container_id=cmd.container_id,
            local_id=bd.block_id.local_id,
            pipeline=Pipeline(ReplicationConfig.from_ec(opts), nodes),
            length=length,
        )

    def _reconstruct_block(
        self, cmd: ReconstructionCommand, bd: BlockData, targets: list[int]
    ) -> None:
        opts = cmd.replication
        cell = opts.cell_size
        bpc = effective_bpc(cell, self.bpc)
        group = self._group_for(cmd, bd)
        reader = ECBlockGroupReader(
            group, opts, self.clients, checksum=self.checksum,
            bytes_per_checksum=bpc, device=self.device,
            qos_class="bulk")  # repair defers to interactive reads
        lengths = unit_true_lengths(group, opts)
        host_checksum = Checksum(self.checksum, bpc)

        # Chunk records are keyed by stripe, so a recovery restart
        # mid-stream overwrites; the one put_block per target below runs
        # only after every batch has landed.
        written: list[dict[int, ChunkInfo]] = [{} for _ in targets]
        for sb, (cells, crcs) in reader.recover_cells_iter(
                [idx - 1 for idx in targets]):
            for ti, idx in enumerate(targets):
                pairs = build_chunk_pairs(
                    group.block_id, sb, cells[:, ti], crcs[:, ti],
                    lengths[idx - 1], cell, bpc, self.checksum, host_checksum)
                for info, _ in pairs:
                    written[ti][info.offset // cell] = info
                if pairs:
                    with Tracer.instance().span("net:write_chunks", unit=idx - 1,
                                                cells=len(pairs)):
                        write_unit_stream(self.clients.get(cmd.targets[idx]),
                                          group.block_id, pairs)
        self.metrics.counter("decode_dispatches").inc(reader.dispatches)

        for ti, idx in enumerate(targets):
            dn = self.clients.get(cmd.targets[idx])
            infos = [written[ti][s] for s in sorted(written[ti])]
            dn.put_block(BlockData(
                group.block_id, infos, block_group_length=group.length,
            ))
            self.metrics.counter("blocks_reconstructed").inc()
            self.metrics.counter("bytes_reconstructed").inc(
                sum(i.length for i in infos)
            )
