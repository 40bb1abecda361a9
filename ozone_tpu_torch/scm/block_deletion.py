"""SCM block-deletion transaction log and deleting service.

Port of `ozone_tpu/scm/block_deletion.py` (the reference's
DeletedBlockLogImpl + SCMBlockDeletingService): the OM hands deleted
keys' blocks to the SCM as transactions; the service batches
per-datanode DeleteBlocksCommands onto heartbeats; datanodes delete the
blocks and ack by transaction id; acked transactions retire, unacked
ones retry up to a cap.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field

from ozone_tpu_torch.scm.node_manager import NodeManager
from ozone_tpu_torch.storage.ids import BlockID


@dataclass
class DeleteBlocksCommand:
    """Per-datanode deletion batch riding a heartbeat."""

    tx_ids: list[int]
    blocks: list[BlockID]


@dataclass
class _DeleteTx:
    tx_id: int
    block: BlockID
    datanodes: list[str]
    acked: set[str] = field(default_factory=set)
    attempts: int = 0


class DeletedBlockLog:
    """Pending deletion transactions."""

    MAX_ATTEMPTS = 5

    def __init__(self):
        self._txs: dict[int, _DeleteTx] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def add(self, block: BlockID, datanodes: list[str]) -> int:
        with self._lock:
            tx = _DeleteTx(next(self._ids), block, list(datanodes))
            self._txs[tx.tx_id] = tx
            return tx.tx_id

    def pending_for(self, dn_id: str, limit: int = 100) -> list[_DeleteTx]:
        with self._lock:
            out = []
            for tx in self._txs.values():
                if dn_id in tx.datanodes and dn_id not in tx.acked:
                    out.append(tx)
                    if len(out) >= limit:
                        break
            return out

    def ack(self, dn_id: str, tx_ids: list[int]) -> None:
        with self._lock:
            for t in tx_ids:
                tx = self._txs.get(t)
                if tx is None:
                    continue
                tx.acked.add(dn_id)
                if tx.acked >= set(tx.datanodes):
                    del self._txs[tx.tx_id]

    def retire_failed(self) -> list[_DeleteTx]:
        """Drop transactions that exceeded the retry cap."""
        with self._lock:
            dead = [
                t for t in self._txs.values()
                if t.attempts > self.MAX_ATTEMPTS
            ]
            for t in dead:
                del self._txs[t.tx_id]
            return dead

    def pending_count(self) -> int:
        return len(self._txs)


class BlockDeletingService:
    """Queues per-datanode DeleteBlocksCommands."""

    def __init__(self, deleted_log: DeletedBlockLog, nodes: NodeManager,
                 batch: int = 100):
        self.log = deleted_log
        self.nodes = nodes
        self.batch = batch

    def run_once(self) -> int:
        queued = 0
        for n in self.nodes.healthy_in_service():
            txs = self.log.pending_for(n.dn_id, self.batch)
            if not txs:
                continue
            for t in txs:
                t.attempts += 1
            self.nodes.queue_command(
                n.dn_id,
                DeleteBlocksCommand(
                    [t.tx_id for t in txs], [t.block for t in txs]
                ),
            )
            queued += len(txs)
        self.log.retire_failed()
        return queued
