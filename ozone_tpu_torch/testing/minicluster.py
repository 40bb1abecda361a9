"""MiniOzoneCluster: a whole cluster in one process.

Port of `MiniOzoneCluster` from `ozone_tpu/testing/minicluster.py` (the
reference's MiniOzoneClusterImpl): a StorageContainerManager, an
OzoneManager and N Datanodes wired through the in-process client
factory, with a manual or background heartbeat pump and a command loop
that runs the SCM's commands on the datanodes the way
DatanodeStateMachine's handlers do: reconstruction on the port's
`ECReconstructionCoordinator` (one device, no mesh), block deletion,
replica deletion and container copies. The codec runs on `device`
("cuda" launches the fused kernel and raises when CUDA is absent; "cpu"
runs its plain version). The HA and sharded clusters are not ported.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Optional

from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.scm.block_deletion import DeleteBlocksCommand
from ozone_tpu_torch.scm.replication_manager import (
    DeleteReplicaCommand,
    ReplicateCommand,
)
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import BlockData, StorageError
from ozone_tpu_torch.storage.reconstruction import (
    ECReconstructionCoordinator,
    ReconstructionCommand,
)

log = logging.getLogger(__name__)


class MiniOzoneCluster:
    def __init__(
        self,
        root: Path,
        num_datanodes: int = 5,
        racks: int = 1,
        block_size: int = 16 * 1024 * 1024,
        container_size: int = 256 * 1024 * 1024,
        stale_after_s: float = 9.0,
        dead_after_s: float = 30.0,
        placement_seed: Optional[int] = 42,
        device="cuda",
    ):
        self.root = Path(root)
        self.device = resolve_device(device)
        self.scm = StorageContainerManager(
            min_datanodes=min(num_datanodes, 1),
            container_size=container_size,
            placement_seed=placement_seed,
            stale_after_s=stale_after_s,
            dead_after_s=dead_after_s,
        )
        self.clients = DatanodeClientFactory()
        self.datanodes: list[Datanode] = []
        for i in range(num_datanodes):
            dn = Datanode(self.root / f"dn{i}", dn_id=f"dn{i}")
            self.datanodes.append(dn)
            self.clients.register_local(dn)
            rack = f"/rack{i % racks}" if racks > 1 else "/default-rack"
            self.scm.register_datanode(dn.id, rack=rack,
                                       capacity_bytes=10 * container_size)
        self.om = OzoneManager(self.root / "om" / "om.db", self.scm,
                               block_size=block_size)
        self.reconstruction = ECReconstructionCoordinator(
            self.clients, device=self.device)
        self._stopped_dns: set[str] = set()
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------------------------------------------- client
    def client(self) -> OzoneClient:
        return OzoneClient(self.om, self.clients, device=self.device)

    def datanode(self, dn_id: str) -> Datanode:
        return next(d for d in self.datanodes if d.id == dn_id)

    # -------------------------------------------------------------- liveness
    def stop_datanode(self, dn_id: str) -> None:
        """Simulate a crash: stop heartbeating and unregister the client so
        IO to this node fails."""
        self._stopped_dns.add(dn_id)
        self.clients._local.pop(dn_id, None)

    def restart_datanode(self, dn_id: str) -> None:
        self._stopped_dns.discard(dn_id)
        self.clients.register_local(self.datanode(dn_id))

    # -------------------------------------------------------------- heartbeat
    def heartbeat_all(self, with_reports: bool = True) -> None:
        """One heartbeat round: every live datanode reports and runs the
        commands it gets back."""
        for dn in self.datanodes:
            if dn.id in self._stopped_dns:
                continue
            report = dn.container_report() if with_reports else None
            commands = self.scm.heartbeat(dn.id, container_report=report)
            for cmd in commands:
                self._execute_command(dn, cmd)

    def _execute_command(self, dn: Datanode, cmd) -> None:
        try:
            if isinstance(cmd, DeleteBlocksCommand):
                for bid in cmd.blocks:
                    try:
                        dn.delete_block(bid)
                    except StorageError:
                        pass
                self.scm.deleted_blocks.ack(dn.id, cmd.tx_ids)
            elif isinstance(cmd, ReconstructionCommand):
                self.reconstruction.reconstruct_container_group(cmd)
                for idx in cmd.targets:
                    self.scm.replication.op_completed(cmd.container_id, idx)
            elif isinstance(cmd, DeleteReplicaCommand):
                dn.delete_container(cmd.container_id, force=True)
            elif isinstance(cmd, ReplicateCommand):
                self._replicate_container(cmd)
                self.scm.replication.op_completed(cmd.container_id)
            else:
                log.debug("ignoring command %r", cmd)
        except Exception:
            log.exception("command %r failed on %s", cmd, dn.id)
            if isinstance(cmd, ReconstructionCommand):
                for idx in cmd.targets:
                    self.scm.replication.op_completed(cmd.container_id, idx)
            elif isinstance(cmd, ReplicateCommand):
                self.scm.replication.op_completed(cmd.container_id)

    def _replicate_container(self, cmd: ReplicateCommand) -> None:
        """In-process container copy (DownloadAndImportReplicator)."""
        src = self.clients.get(cmd.source)
        dst = self.clients.get(cmd.target)
        blocks = src.list_blocks(cmd.container_id)
        try:
            dst.create_container(cmd.container_id, cmd.replica_index)
        except StorageError as e:
            if e.code != "CONTAINER_EXISTS":
                raise
        for bd in blocks:
            for info in bd.chunks:
                data = src.read_chunk(bd.block_id, info)
                dst.write_chunk(bd.block_id, info, data)
            dst.put_block(
                BlockData(bd.block_id, bd.chunks, bd.block_group_length)
            )
        dst.close_container(cmd.container_id)

    def tick(self, rounds: int = 1) -> None:
        """Heartbeats and the SCM's control loops, n times."""
        for _ in range(rounds):
            self.heartbeat_all()
            self.scm.run_background_once()
            self.heartbeat_all()  # deliver the commands the scan emitted

    def start_heartbeats(self, interval_s: float = 0.5) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    log.exception("heartbeat tick failed")

        self._hb_thread = threading.Thread(
            target=loop, name="mini-heartbeats", daemon=True
        )
        self._hb_thread.start()

    # ----------------------------------------------------------------- admin
    def close(self) -> None:
        self._stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=5)
        self.om.close()
        for dn in self.datanodes:
            dn.close()
