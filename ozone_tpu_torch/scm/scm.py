"""StorageContainerManager: wires node, container and block management,
safemode, block deletion and the replication control loop.

Port of `ozone_tpu/scm/scm.py` (the reference's StorageContainerManager
at framework scale): one object the OM, the datanodes and the
minicluster talk to. Heartbeats carry container reports and take back
queued commands (SCMNodeManager.processHeartbeat); a node's death
forgets its replicas (DeadNodeHandler) so the replication scan rebuilds
them. The minicluster's ticks drive the control loops
(`run_background_once`). With `db_path` the container manager persists
in the SCM store. With `block_tokens` the SCM holds the symmetric secret
keys of block and container tokens (`secret_keys`, the reference's
SecretKeyManager): `ensure_secret_key` mints and rotates them, directly
on a single node and through the metadata ring under HA (the daemon's
`on_secret_rotate` hook; the ring applies the key as the admin op
`import-secret-key`), and the SCM service ships them to datanodes on
every register and heartbeat answer. Of the admin verbs,
`apply_admin_op` serves the two the HA ring replicates: the container
close and the key import (`net/scm_service.py` reads the rest locally).
The cluster CA lives beside it in the metadata daemon (`utils/ca.py`,
`net/daemons.ScmOmDaemon(secure=True)`). Left out for later slices:
layout versions, the balancer, decommission and maintenance, and the
background thread a daemon runs the loops on.
"""

from __future__ import annotations

import logging
from typing import Optional

from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.scm import node_manager as nm
from ozone_tpu_torch.scm.block_deletion import (
    BlockDeletingService,
    DeletedBlockLog,
)
from ozone_tpu_torch.scm.container_manager import ContainerManager
from ozone_tpu_torch.scm.node_manager import NodeManager
from ozone_tpu_torch.scm.pipeline import ReplicationConfig
from ozone_tpu_torch.scm.placement import RackScatterPlacement
from ozone_tpu_torch.scm.replication_manager import ReplicationManager
from ozone_tpu_torch.scm.safemode import SafeModeConfig, SafeModeManager
from ozone_tpu_torch.utils.events import EventQueue
from ozone_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


class StorageContainerManager:
    def __init__(
        self,
        min_datanodes: int = 1,
        container_size: int = 5 * 1024 * 1024 * 1024,
        placement_seed: Optional[int] = None,
        stale_after_s: float = 9.0,
        dead_after_s: float = 30.0,
        db_path=None,
        block_tokens: bool = False,
    ):
        self.events = EventQueue()
        # the token keys; minted lazily by ensure_secret_key, so that HA
        # replicas install the material the ring replicates instead of
        # each making its own
        from ozone_tpu_torch.utils.security import SecretKeyManager

        self.block_tokens = block_tokens
        self.secret_keys = SecretKeyManager(generate=False,
                                            activation_s=10.0)
        #: HA hook: the leader sends a new key through the ring; None =
        #: single node, installed directly
        self.on_secret_rotate = None
        self.nodes = NodeManager(
            self.events, stale_after_s=stale_after_s, dead_after_s=dead_after_s
        )
        self.placement = RackScatterPlacement(self.nodes, seed=placement_seed)
        self.containers = ContainerManager(
            self.nodes, self.placement, container_size=container_size,
            db_path=db_path,
        )
        self.safemode = SafeModeManager(
            self.nodes, self.containers, SafeModeConfig(min_datanodes)
        )
        self.replication = ReplicationManager(
            self.containers, self.nodes, self.placement
        )
        self.deleted_blocks = DeletedBlockLog()
        self.block_deleting = BlockDeletingService(
            self.deleted_blocks, self.nodes
        )
        self.metrics = MetricsRegistry("scm")
        #: dead node -> ids of the containers whose replicas the SCM
        #: forgot at its death (the reconstruction storm's plan reads it)
        self.dead_node_containers: dict[str, list[int]] = {}
        self.events.subscribe(nm.DEAD_NODE, self._on_dead_node)

    # ------------------------------------------------------------- datanodes
    def register_datanode(self, dn_id: str, rack: str = "/default-rack",
                          capacity_bytes: int = 0) -> None:
        self.nodes.register(dn_id, rack, capacity_bytes)
        self.metrics.counter("registrations").inc()

    def heartbeat(
        self,
        dn_id: str,
        container_report: Optional[list[dict]] = None,
        used_bytes: int = 0,
        deleted_block_acks: Optional[list[int]] = None,
    ) -> list:
        """Process a heartbeat (with an optional full container report and
        block-deletion acks); return the commands queued for the node."""
        if deleted_block_acks:
            self.deleted_blocks.ack(dn_id, deleted_block_acks)
        if container_report is not None:
            self.containers.process_container_report(dn_id, container_report)
            # CLOSING -> CLOSED once replicas report closed
            for r in container_report:
                c = self.containers.get_or_none(int(r["container_id"]))
                if (
                    c is not None
                    and r["state"] in ("CLOSED", "QUASI_CLOSED")
                    and c.state.value in ("OPEN", "CLOSING")
                ):
                    self.containers.mark_closed(c.id)
        self.metrics.counter("heartbeats").inc()
        return self.nodes.process_heartbeat(dn_id, used_bytes)

    def _on_dead_node(self, dn_id: str) -> None:
        # events are published outside the NodeManager lock, so the node
        # may have heartbeated back since: re-validate before forgetting
        # a healthy node's replicas
        n = self.nodes.get(dn_id)
        if n is None or n.state is not nm.NodeState.DEAD:
            log.info("node %s recovered before dead-node handling; skipped",
                     dn_id)
            return
        affected = self.containers.remove_replicas_of_node(dn_id)
        self.dead_node_containers[dn_id] = affected
        log.info("node %s dead; %d containers affected", dn_id, len(affected))
        self.metrics.counter("dead_nodes").inc()

    # ------------------------------------------------------------- allocation
    def allocate_block(
        self,
        replication: ReplicationConfig,
        block_size: int,
        excluded: Optional[list[str]] = None,
        excluded_containers: Optional[list[int]] = None,
    ) -> BlockGroup:
        self.safemode.check_allocation_allowed()
        g = self.containers.allocate_block(replication, block_size, excluded,
                                           excluded_containers)
        self.metrics.counter("blocks_allocated").inc()
        return g

    def delete_blocks(self, entries: list[tuple]) -> list[int]:
        """OM -> SCM deletion handoff: entries of (BlockID, datanode ids)."""
        tx_ids = [
            self.deleted_blocks.add(bid, nodes) for bid, nodes in entries
        ]
        self.metrics.counter("block_delete_txs").inc(len(tx_ids))
        return tx_ids

    def apply_admin_op(self, op: str, target=None) -> dict:
        """Deterministic admin mutation and its state read-back: one
        function for the direct path and the HA ring's replicated apply,
        so every replica ends in the same state."""
        from ozone_tpu_torch.storage.ids import ContainerState, StorageError

        if op == "import-secret-key":
            # a token-key rotation, possibly applied from the ring
            from ozone_tpu_torch.utils.security import SecretKey

            self.secret_keys.import_key(SecretKey.from_json(target))
            return {"key_id": target["key_id"]}
        if op != "close-container":
            raise StorageError("UNSUPPORTED_REQUEST", f"admin op {op!r}")
        try:
            cid = int(str(target), 0)
        except (TypeError, ValueError):
            raise StorageError("INVALID", f"bad container id {target!r}")
        c = self.containers.get_or_none(cid)
        if c is None:
            raise StorageError("CONTAINER_NOT_FOUND", f"no container {target}")
        if c.state is ContainerState.OPEN:
            # the normal close flow: CLOSING, and close commands to the
            # replicas; their reports mark it CLOSED
            self.containers.finalize_container(c.id)
        return {"container": c.id, "state": c.state.value}

    def status(self) -> dict:
        """Safemode, the nodes with their usage columns and the container
        count: the body of the SCM service's Status answer
        (ozone_tpu/net/scm_service.py `_status`), read in process. The
        port has no layout versions or pipeline safemode rules yet, so
        their fields are left out."""
        return {
            "safemode": self.safemode.in_safemode(),
            "safemode_status": self.safemode.status(),
            "block_tokens": self.block_tokens,
            "nodes": [
                {
                    "dn_id": n.dn_id,
                    "rack": n.rack,
                    "state": n.state.value,
                    "op_state": n.op_state.value,
                    "capacity_bytes": n.capacity_bytes,
                    "used_bytes": n.used_bytes,
                    "used_pct": round(
                        100.0 * n.used_bytes / n.capacity_bytes, 2)
                    if n.capacity_bytes else None,
                    "healthy_volumes": n.healthy_volumes,
                }
                for n in self.nodes.nodes()
            ],
            "containers": len(self.containers.containers()),
        }

    # ------------------------------------------------------------- security
    def ensure_secret_key(self) -> None:
        """Mint or rotate the token-signing key when due: installed here
        on a single node, sent through the ring under HA (so every
        replica, and every OM issuer, signs with the same keys)."""
        if not self.block_tokens or not self.secret_keys.needs_rotation():
            return
        key = self.secret_keys.new_key()
        if self.on_secret_rotate is not None:
            self.on_secret_rotate(key)
        else:
            self.secret_keys.import_key(key)

    # ------------------------------------------------------------- background
    def run_background_once(self) -> None:
        """One tick of the SCM control loops: the token key's rotation,
        liveness, then (out of safemode) the replication scan and the
        block-deletion batches."""
        self.ensure_secret_key()
        self.nodes.check_liveness()
        if not self.safemode.in_safemode():
            self.replication.run_once()
            self.block_deleting.run_once()
