"""Replication manager: detect and repair under-, over- and unrecoverable
replication.

Port of `ozone_tpu/scm/replication_manager.py` (the reference's
ReplicationManager processContainer scan with the EC machinery:
per-replica-index accounting, ECContainerReplicaCount; reconstruction
commands, ECUnderReplicationHandler -> ReconstructECContainersCommand;
over-replication trimming; plain re-replication for replicated
containers). Commands are queued on datanodes through the NodeManager
and ride heartbeat responses; a reconstruction is the port's
`storage/reconstruction.ReconstructionCommand`, which the minicluster's
command loop runs on the port's coordinator.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ozone_tpu_torch.scm.container_manager import ContainerInfo, ContainerManager
from ozone_tpu_torch.scm.node_manager import (
    NodeManager,
    NodeOperationalState,
    NodeState,
)
from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.scm.placement import PlacementError, PlacementPolicy
from ozone_tpu_torch.storage.ids import ContainerState
from ozone_tpu_torch.storage.reconstruction import ReconstructionCommand
from ozone_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


@dataclass
class ReplicateCommand:
    """Copy a container replica to a target node (ReplicateContainerCommand)."""

    container_id: int
    source: str
    target: str
    replica_index: int = 0


@dataclass
class DeleteReplicaCommand:
    container_id: int
    replica_index: int = 0


@dataclass
class HealthReport:
    under_replicated: list[int] = field(default_factory=list)
    over_replicated: list[int] = field(default_factory=list)
    unrecoverable: list[int] = field(default_factory=list)


class ECReplicaCount:
    """Per-replica-index accounting for one EC container. Replicas on
    nodes out of service don't count toward redundancy but are kept as
    copy sources (a draining node's index is copied, not rebuilt)."""

    def __init__(self, container: ContainerInfo, nodes: NodeManager):
        self.container = container
        k = container.replication.ec.all_units
        self.expected = set(range(1, k + 1))
        self.present: dict[int, list[str]] = {}
        self.draining: dict[int, str] = {}  # index -> out-of-service holder
        for dn_id, r in container.replicas.items():
            n = nodes.get(dn_id)
            if n is None or n.state is NodeState.DEAD:
                continue
            if r.state in ("UNHEALTHY", "DELETED", "INVALID"):
                continue
            if n.op_state is not NodeOperationalState.IN_SERVICE:
                self.draining.setdefault(r.replica_index, dn_id)
                continue
            self.present.setdefault(r.replica_index, []).append(dn_id)

    @property
    def missing_indexes(self) -> list[int]:
        return sorted(self.expected - set(self.present))

    @property
    def excess_indexes(self) -> dict[int, list[str]]:
        return {
            i: dns[1:] for i, dns in self.present.items() if len(dns) > 1
        }

    @property
    def recoverable(self) -> bool:
        k = self.container.replication.ec.data_units
        return len(set(self.present) | set(self.draining)) >= k


class ReplicationManager:
    def __init__(
        self,
        containers: ContainerManager,
        nodes: NodeManager,
        placement: PlacementPolicy,
    ):
        self.containers = containers
        self.nodes = nodes
        self.placement = placement
        self.metrics = MetricsRegistry("scm.replication")
        # in-flight op dedup (ContainerReplicaPendingOps analog)
        self._pending: set[tuple[int, int]] = set()  # (container, index)

    # ------------------------------------------------------------------ scan
    def run_once(self) -> HealthReport:
        report = HealthReport()
        for c in self.containers.containers():
            if c.state in (ContainerState.DELETED, ContainerState.OPEN):
                continue  # open containers are the write path's business
            try:
                self._process_container(c, report)
            except Exception:
                log.exception("processing container %s failed", c.id)
        self.metrics.gauge("under_replicated").set(len(report.under_replicated))
        self.metrics.gauge("over_replicated").set(len(report.over_replicated))
        self.metrics.gauge("unrecoverable").set(len(report.unrecoverable))
        return report

    def _process_container(self, c: ContainerInfo, report: HealthReport) -> None:
        if c.replication.type is ReplicationType.EC:
            self._process_ec(c, report)
        else:
            self._process_ratis(c, report)

    # ------------------------------------------------------------------ EC
    def _process_ec(self, c: ContainerInfo, report: HealthReport) -> None:
        count = ECReplicaCount(c, self.nodes)
        missing = [
            i for i in count.missing_indexes if (c.id, i) not in self._pending
        ]
        if count.missing_indexes and not count.recoverable:
            report.unrecoverable.append(c.id)
            self.metrics.counter("unrecoverable_seen").inc()
            return
        if missing:
            report.under_replicated.append(c.id)
            # indexes still held by draining nodes: plain copy, not decode
            copyable = [i for i in missing if i in count.draining]
            rebuild = [i for i in missing if i not in count.draining]
            for i in copyable:
                src = count.draining[i]
                exclude = [
                    dn for dns in count.present.values() for dn in dns
                ] + [src]
                try:
                    target = self.placement.choose(1, exclude)[0]
                except PlacementError as e:
                    log.warning("no copy target for %s idx %s: %s", c.id, i, e)
                    continue
                self.nodes.queue_command(
                    target.dn_id,
                    ReplicateCommand(c.id, source=src, target=target.dn_id,
                                     replica_index=i),
                )
                self._pending.add((c.id, i))
            if rebuild:
                self._emit_reconstruction(c, count, rebuild)
        for idx, extra_dns in count.excess_indexes.items():
            report.over_replicated.append(c.id)
            for dn in extra_dns:
                self.nodes.queue_command(
                    dn, DeleteReplicaCommand(c.id, replica_index=idx)
                )

    def _emit_reconstruction(
        self, c: ContainerInfo, count: ECReplicaCount, missing: list[int]
    ) -> None:
        sources = {i: dns[0] for i, dns in count.present.items()}
        exclude = [dn for dns in count.present.values() for dn in dns]
        try:
            chosen = self.placement.choose(len(missing), exclude)
        except PlacementError as e:
            log.warning("no targets for reconstruction of %s: %s", c.id, e)
            return
        targets = {i: n.dn_id for i, n in zip(missing, chosen)}
        cmd = ReconstructionCommand(
            container_id=c.id,
            replication=c.replication.ec,
            sources=sources,
            targets=targets,
        )
        # the first target coordinates: the command goes to one datanode,
        # which rebuilds every target
        self.nodes.queue_command(chosen[0].dn_id, cmd)
        for i in missing:
            self._pending.add((c.id, i))
        self.metrics.counter("reconstructions_emitted").inc()

    # ------------------------------------------------------------------ Ratis
    def _process_ratis(self, c: ContainerInfo, report: HealthReport) -> None:
        live = [
            dn
            for dn, r in c.replicas.items()
            if (n := self.nodes.get(dn)) is not None
            and n.state is not NodeState.DEAD
            and r.state not in ("UNHEALTHY", "DELETED")
        ]
        want = c.replication.factor
        if len(live) < want:
            if not live:
                report.unrecoverable.append(c.id)
                return
            report.under_replicated.append(c.id)
            if (c.id, 0) in self._pending:
                return
            try:
                chosen = self.placement.choose(want - len(live), live)
            except PlacementError as e:
                log.warning("no replication targets for %s: %s", c.id, e)
                return
            for n in chosen:
                self.nodes.queue_command(
                    n.dn_id,
                    ReplicateCommand(c.id, source=live[0], target=n.dn_id),
                )
            self._pending.add((c.id, 0))
        elif len(live) > want:
            report.over_replicated.append(c.id)
            for dn in live[want:]:
                self.nodes.queue_command(dn, DeleteReplicaCommand(c.id))

    # ------------------------------------------------------------------ acks
    def op_completed(self, container_id: int, replica_index: int = 0) -> None:
        self._pending.discard((container_id, replica_index))
