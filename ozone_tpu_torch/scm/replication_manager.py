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

Where the port departs from the reference on purpose: a planned
(container, index) is no longer pending once a replica of that index is
reported, and a plan not done within `PENDING_TIMEOUT_S` (the upstream
event timeout, 10 minutes) is planned again. The reference clears its
pending set only through `op_completed`, which no daemon calls: a plan
that failed (a target that already held the container, because the SCM
planned a replica it had not heard of yet) blocked that index's repair
for good, and a rebuilt index could never be rebuilt again. And when a
node goes DEAD (`node_dead`), the pending plans that read from it or
write to it are dropped, so the next scan plans those indexes anew: a
copy planned off a draining node that then stopped is rebuilt by decode
once the node is declared dead, where the reference keeps it pending.
An index the balancer is moving (`moving`, set by the SCM) keeps its
excess replica for the move to delete. A container this SCM saw close
is not planned until every HEALTHY member has sent a full report since
(ROADMAP Queue 3 item 3): the reference plans at once, counts a member
whose report is late as lost, and sends its index to a node that holds
it, which refuses with CONTAINER_EXISTS.

Two behaviours are the reference's own and kept (ROADMAP Queue 3): an
excess replica's DeleteReplicaCommand is queued again on every scan
until a report drops the replica, so a late duplicate fails with
CONTAINER_NOT_FOUND; and a copy planned off a draining node that stops
fails, with no new plan until the node is DEAD.
"""

from __future__ import annotations

import logging
import time
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
    #: seconds after which a planned op that never completed is planned
    #: again (upstream's hdds.scm.replication.event.timeout)
    PENDING_TIMEOUT_S = 600.0

    def __init__(
        self,
        containers: ContainerManager,
        nodes: NodeManager,
        placement: PlacementPolicy,
    ):
        self.containers = containers
        self.nodes = nodes
        self.placement = placement
        #: when a plan is made (a test substitutes a fake)
        self.clock = time.monotonic
        self.metrics = MetricsRegistry("scm.replication")
        # in-flight op dedup (ContainerReplicaPendingOps analog):
        # (container, index) -> when it was planned, and the nodes the
        # plan reads from or writes to
        self._pending: dict[tuple[int, int], float] = {}
        self._pending_nodes: dict[tuple[int, int], frozenset] = {}
        #: callable(container, index) -> True while the balancer moves that
        #: replica: its excess copy is the move's to delete
        self.moving = None

    # ------------------------------------------------------------------ scan
    def run_once(self) -> HealthReport:
        report = HealthReport()
        now = self.clock()
        for op, t in list(self._pending.items()):
            if now - t > self.PENDING_TIMEOUT_S:
                self._unpend(op)  # never completed: plan it again
                self.metrics.counter("pending_expired").inc()
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

    def _reported_since_close(self, c: ContainerInfo) -> bool:
        """Every HEALTHY member of a container this SCM saw close has sent a
        full report since: until then a member whose report is late would
        count as lost, and its index be planned onto a node that holds it."""
        if c.closed_at is None or c.pipeline is None:
            return True
        for dn in c.pipeline.nodes:
            n = self.nodes.get(dn)
            if n is not None and n.state is NodeState.HEALTHY \
                    and n.last_report < c.closed_at:
                return False
        return True

    def _process_container(self, c: ContainerInfo, report: HealthReport) -> None:
        if not self._reported_since_close(c):
            self.metrics.counter("held_for_reports").inc()
            return
        if c.replication.type is ReplicationType.EC:
            self._process_ec(c, report)
        else:
            self._process_ratis(c, report)

    # ------------------------------------------------------------------ EC
    def _process_ec(self, c: ContainerInfo, report: HealthReport) -> None:
        count = ECReplicaCount(c, self.nodes)
        for i in count.present:  # completed: the index is reported
            self._unpend((c.id, i))
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
                self._plan((c.id, i), (src, target.dn_id))
            if rebuild:
                self._emit_reconstruction(c, count, rebuild)
        for idx, extra_dns in count.excess_indexes.items():
            report.over_replicated.append(c.id)
            if self.moving is not None and self.moving(c.id, idx):
                continue
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
        involved = (*sources.values(), *targets.values())
        for i in missing:
            self._plan((c.id, i), involved)
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
        if len(live) >= want:
            self._unpend((c.id, 0))  # completed by a report
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
            self._plan((c.id, 0), (live[0], *(n.dn_id for n in chosen)))
        elif len(live) > want:
            report.over_replicated.append(c.id)
            if self.moving is not None and self.moving(c.id, 0):
                return
            for dn in live[want:]:
                self.nodes.queue_command(dn, DeleteReplicaCommand(c.id))

    # ------------------------------------------------------------------ acks
    def _plan(self, op: tuple[int, int], nodes) -> None:
        self._pending[op] = self.clock()
        self._pending_nodes[op] = frozenset(nodes)

    def _unpend(self, op: tuple[int, int]) -> None:
        self._pending.pop(op, None)
        self._pending_nodes.pop(op, None)

    def op_completed(self, container_id: int, replica_index: int = 0) -> None:
        self._unpend((container_id, replica_index))

    def node_dead(self, dn_id: str) -> list[tuple[int, int]]:
        """Drop the pending plans that read from or write to a node just
        declared DEAD (they cannot complete); returns them."""
        dropped = [op for op, nodes in list(self._pending_nodes.items())
                   if dn_id in nodes]
        for op in dropped:
            self._unpend(op)
        if dropped:
            self.metrics.counter("pending_dropped_dead").inc(len(dropped))
        return dropped
