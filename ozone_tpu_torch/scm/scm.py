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
every register and heartbeat answer. `apply_admin_op` serves every
mutating admin verb, on the direct path and as the HA ring's replicated
apply: decommission, recommission and maintenance (the drain monitor,
`scm/decommission.py`, with the op state persisted in the SCM store and
echoed by the node), the container and pipeline close, the balancer's
start (with config overrides) and stop, safemode enter and exit, and
the key import (`net/scm_service.py` reads the rest locally). The
balancer (`scm/balancer.py`) keeps its config and progress in the
store's service-state row, so a restarted or promoted SCM resumes it.
`run_background_once` is one tick of the loops (liveness, replication,
decommission, block deletion, the close re-announce, the balancer);
`start_background` runs them on a thread. The cluster CA lives beside
it in the metadata daemon (`utils/ca.py`,
`net/daemons.ScmOmDaemon(secure=True)`). Upgrade: with `db_path` the
metadata services' layout version persists beside the store
(`layout_version.json`, `utils/upgrade.LayoutVersionManager`, read by
the OM's request gate), the admin op `finalize-upgrade` runs the
finalizer and queues a `finalize` command for every datanode, and each
heartbeat's `layout_version` lands in the node table.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.scm import node_manager as nm
from ozone_tpu_torch.scm.balancer import ContainerBalancer
from ozone_tpu_torch.scm.block_deletion import (
    BlockDeletingService,
    DeletedBlockLog,
)
from ozone_tpu_torch.scm.container_manager import ContainerManager
from ozone_tpu_torch.scm.decommission import DecommissionMonitor
from ozone_tpu_torch.scm.node_manager import NodeManager
from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.scm.placement import RackScatterPlacement
from ozone_tpu_torch.scm.replication_manager import (
    ECReplicaCount,
    ReplicationManager,
)
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
        # the op states: the store is authoritative across restarts, the
        # nodes' echo covers an SCM that lost it
        self.nodes.seed_op_states(self.containers.node_op_states())
        self.nodes.on_op_state_change = \
            self.containers.persist_node_op_state
        self.safemode = SafeModeManager(
            self.nodes, self.containers, SafeModeConfig(min_datanodes)
        )
        # the metadata services' layout version (HDDSLayoutFeature),
        # persisted beside the SCM store when there is one; without one
        # there is no finalizer and every feature is allowed
        self.layout = None
        self.finalizer = None
        if db_path is not None:
            from pathlib import Path

            from ozone_tpu_torch.utils.upgrade import (
                LayoutVersionManager,
                UpgradeFinalizer,
            )

            self.layout = LayoutVersionManager(
                Path(db_path).parent / "layout_version.json")
            # one finalizer, so features can register their actions on it
            self.finalizer = UpgradeFinalizer(self.layout)
        self.replication = ReplicationManager(
            self.containers, self.nodes, self.placement
        )
        self.balancer = ContainerBalancer(self.containers, self.nodes)
        self.replication.moving = self.balancer.moving
        # resume a persisted balancing run: config and progress come back
        # from the store; the running flag is read live from it
        self._hydrate_balancer_from_state()
        self.decommission_monitor = DecommissionMonitor(
            self.nodes, self.containers, self.replication)
        self.deleted_blocks = DeletedBlockLog()
        self.block_deleting = BlockDeletingService(
            self.deleted_blocks, self.nodes
        )
        self.metrics = MetricsRegistry("scm")
        #: dead node -> ids of the containers whose replicas the SCM
        #: forgot at its death (the reconstruction storm's plan reads it)
        self.dead_node_containers: dict[str, list[int]] = {}
        self.events.subscribe(nm.DEAD_NODE, self._on_dead_node)
        self._bg: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- datanodes
    def register_datanode(self, dn_id: str, rack: str = "/default-rack",
                          capacity_bytes: int = 0,
                          op_state: Optional[str] = None,
                          container_report: Optional[list[dict]] = None
                          ) -> None:
        """Register a node with the op state it echoes and, as upstream's
        register request does, its full container report: an SCM that
        asked a node to register again (after a restart) learns its
        replicas in the same step."""
        self.nodes.register(dn_id, rack, capacity_bytes, op_state=op_state)
        if container_report is not None:
            self._ingest_report(dn_id, container_report)
        self.metrics.counter("registrations").inc()

    def _ingest_report(self, dn_id: str, report: list[dict]) -> None:
        self.containers.process_container_report(dn_id, report)
        # CLOSING -> CLOSED once replicas report closed
        for r in report:
            c = self.containers.get_or_none(int(r["container_id"]))
            if (
                c is not None
                and r["state"] in ("CLOSED", "QUASI_CLOSED")
                and c.state.value in ("OPEN", "CLOSING")
            ):
                self.containers.mark_closed(c.id)
        # after the close it may have caused: this report is one since it
        n = self.nodes.get(dn_id)
        if n is not None:
            n.last_report = self.nodes.clock()

    def heartbeat(
        self,
        dn_id: str,
        container_report: Optional[list[dict]] = None,
        used_bytes: int = 0,
        deleted_block_acks: Optional[list[int]] = None,
        healthy_volumes: Optional[int] = None,
        layout_version: Optional[int] = None,
    ) -> list:
        """Process a heartbeat (with an optional full container report,
        block-deletion acks, the node's healthy-volume count and its
        layout version); return the commands queued for the node."""
        if deleted_block_acks:
            self.deleted_blocks.ack(dn_id, deleted_block_acks)
        if container_report is not None:
            self._ingest_report(dn_id, container_report)
        self.metrics.counter("heartbeats").inc()
        if healthy_volumes is not None or layout_version is not None:
            n = self.nodes.get(dn_id)
            if n is not None:
                if healthy_volumes is not None:
                    n.healthy_volumes = int(healthy_volumes)
                if layout_version is not None:
                    n.layout_version = int(layout_version)
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
        # plans that read from or write to it cannot complete
        self.replication.node_dead(dn_id)
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

    # ------------------------------------------------------------- admin ops
    def decommission(self, dn_id: str) -> None:
        """Start draining a node (NodeDecommissionManager): out of
        placement; the replication manager re-protects its containers and
        the monitor finalizes it once drained."""
        self.decommission_monitor.start_decommission(dn_id)

    def apply_admin_op(self, op: str, target=None) -> dict:
        """Deterministic admin mutation and its state read-back: one
        function for the direct path and the HA ring's replicated apply,
        so every replica ends in the same state."""
        from ozone_tpu_torch.storage.ids import ContainerState, StorageError

        if op in ("decommission", "recommission", "maintenance"):
            node = self.nodes.get(target) if target else None
            if node is None:
                raise StorageError("NODE_NOT_FOUND",
                                   f"unknown datanode {target!r}")
            if op == "decommission":
                self.decommission(target)
            elif op == "recommission":
                self.decommission_monitor.recommission(target)
            else:
                self.decommission_monitor.start_maintenance(target)
            return {"node": target, "op_state": node.op_state.value}
        if op == "finalize-upgrade":
            # the metadata services finalize here; every datanode is
            # commanded to finalize on its next heartbeat
            state = None
            if self.finalizer is not None:
                state = self.finalizer.finalize().value
            for n in self.nodes.nodes():
                self.nodes.queue_command(n.dn_id, {"type": "finalize"})
            return {"scm": state,
                    "datanodes_notified": self.nodes.node_count()}

        def numeric_id(kind: str) -> int:
            try:
                return int(str(target), 0)
            except (TypeError, ValueError):
                raise StorageError("INVALID", f"bad {kind} id {target!r}")

        if op == "close-container":
            c = self.containers.get_or_none(numeric_id("container"))
            if c is None:
                raise StorageError("CONTAINER_NOT_FOUND",
                                   f"no container {target}")
            if c.state is ContainerState.OPEN:
                # the normal close flow: CLOSING, and close commands to
                # the replicas; their reports mark it CLOSED
                self.containers.finalize_container(c.id)
            return {"container": c.id, "state": c.state.value}
        if op == "close-pipeline":
            # pipelines are 1:1 with their container: closing one
            # finalizes the container (writes stop, members leave the
            # raft group)
            pid = numeric_id("pipeline")
            for c in self.containers.containers():
                if c.pipeline is not None and c.pipeline.id == pid:
                    if c.state is ContainerState.OPEN:
                        self.containers.finalize_container(c.id)
                    return {"pipeline": pid, "container": c.id,
                            "state": c.state.value}
            raise StorageError("PIPELINE_NOT_FOUND",
                               f"unknown pipeline {target!r}")
        if op == "import-secret-key":
            # a token-key rotation, possibly applied from the ring
            from ozone_tpu_torch.utils.security import SecretKey

            self.secret_keys.import_key(SecretKey.from_json(target))
            return {"key_id": target["key_id"]}
        if op == "balancer-start":
            if isinstance(target, dict):
                # the operator's overrides ride the replicated decision,
                # so every replica balances alike
                self._apply_balancer_config(target)
            self.balancer_enabled = True
        elif op == "balancer-stop":
            self.balancer_enabled = False
        elif op == "safemode-enter":
            self.safemode.force(True)
        elif op == "safemode-exit":
            self.safemode.force(False)
        else:
            raise StorageError("UNSUPPORTED_REQUEST", f"admin op {op!r}")
        if op.startswith("balancer"):
            return self.balancer_status()
        return {"safemode": self.safemode.in_safemode(),
                **self.safemode.status()}

    # ------------------------------------------------------------- balancer
    def _apply_balancer_config(self, src: dict) -> None:
        """Copy the config knobs present in `src` onto the live config:
        one field list (dataclasses.fields) for the operator's overrides,
        the row's hydration and the persistence."""
        cfg = self.balancer.config
        for f in dataclasses.fields(cfg):
            if f.name in src:
                setattr(cfg, f.name, type(getattr(cfg, f.name))(src[f.name]))

    def _hydrate_balancer_from_state(self) -> None:
        """Pull the replicated service row into the live balancer: the row
        is authoritative for the config (a promoted follower's balancer
        still holds the defaults), and the progress counters take the
        larger of memory and row."""
        svc = self.containers.service_state("balancer")
        if not svc:
            return
        self._apply_balancer_config(svc)
        st = self.balancer.status
        st.iterations = max(st.iterations, int(svc.get("iterations", 0)))
        st.moves_scheduled = max(st.moves_scheduled,
                                 int(svc.get("moves_scheduled", 0)))
        st.bytes_scheduled = max(st.bytes_scheduled,
                                 int(svc.get("bytes_scheduled", 0)))

    @property
    def balancer_enabled(self) -> bool:
        """The persisted running flag, read live: replicas learn it through
        the replicated row, so a promoted follower resumes balancing."""
        svc = self.containers.service_state("balancer")
        return bool(svc and svc.get("running"))

    @balancer_enabled.setter
    def balancer_enabled(self, running: bool) -> None:
        self._persist_balancer_state(running=bool(running))

    def _persist_balancer_state(self, running=None) -> None:
        """Write the balancer's service row (config and progress,
        ContainerBalancer.saveConfiguration) through the store."""
        svc = self.containers.service_state("balancer") or {}
        if running is None:
            running = bool(svc.get("running"))
        st = self.balancer.status
        self.containers.persist_service_state("balancer", {
            "running": bool(running),
            **dataclasses.asdict(self.balancer.config),
            "iterations": st.iterations,
            "moves_scheduled": st.moves_scheduled,
            "bytes_scheduled": st.bytes_scheduled,
        })

    def balancer_status(self) -> dict:
        """Live progress: the in-memory counters run ahead of the row on
        iterations that moved nothing (those are not persisted), so the
        larger of the two is reported."""
        svc = self.containers.service_state("balancer") or {}
        st = self.balancer.status
        return {
            "running": self.balancer_enabled,
            "iterations": max(st.iterations, int(svc.get("iterations", 0))),
            "moves_scheduled": max(st.moves_scheduled,
                                   int(svc.get("moves_scheduled", 0))),
            "bytes_scheduled": max(st.bytes_scheduled,
                                   int(svc.get("bytes_scheduled", 0))),
            "threshold": float(
                svc.get("threshold", self.balancer.config.threshold)),
        }

    def replication_status(self) -> dict:
        """Containers by replication health (Recon's container-health
        census, which `admin replicationmanager` reads): counts of
        healthy, under-, over-replicated and missing."""
        from ozone_tpu_torch.recon.recon import ReconScmView

        return {k: len(v) for k, v in
                ReconScmView(self).container_health().items()}

    def status(self) -> dict:
        """Safemode, the nodes with their usage columns and the container
        count: the body of the SCM service's Status answer
        (ozone_tpu/net/scm_service.py `_status`), read in process. The
        port has no pipeline safemode rules yet, so their fields are left
        out."""
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
                    "layout_version": n.layout_version,
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
        liveness, then (out of safemode) the replication scan, the drain
        monitor, the block-deletion batches, the close re-announce and,
        while it runs, a balancer iteration."""
        self.ensure_secret_key()
        self.nodes.check_liveness()
        if not self.safemode.in_safemode():
            self.balancer.settle()
            self.replication.run_once()
            self.decommission_monitor.run_once()
            self.block_deleting.run_once()
            self.containers.resend_closing()
            if self.balancer_enabled:
                # the replicated row first: a freshly promoted follower
                # balances with the operator's config, not the defaults
                self._hydrate_balancer_from_state()
                if self.balancer.run_iteration():
                    # progress is persisted only when something moved: an
                    # idle tick appends no record
                    self._persist_balancer_state()

    def start_background(self, interval_s: float = 1.0) -> None:
        """Run the control loops on a thread every interval_s."""
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.run_background_once()
                except Exception:
                    log.exception("scm background tick failed")

        self._bg = threading.Thread(target=loop, name="scm-bg", daemon=True)
        self._bg.start()

    def stop(self) -> None:
        self._stop.set()
        if self._bg:
            self._bg.join(timeout=5)
