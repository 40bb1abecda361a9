"""Decommission and maintenance: the drain monitor.

Port of `ozone_tpu/scm/decommission.py` (the reference's
NodeDecommissionManager with DatanodeAdminMonitorImpl): a node entering
DECOMMISSIONING or IN_MAINTENANCE stops receiving new allocations
(placement takes IN_SERVICE nodes only), the replication manager
re-protects its replicas (copying from the draining node while its
replica is live: `ECReplicaCount.draining`), and the monitor flips a
DECOMMISSIONING node to DECOMMISSIONED once every container it held is
fully replicated elsewhere. `recommission` returns a node to service;
its replicas then count again and the excess copies are deleted.
"""

from __future__ import annotations

import logging

from ozone_tpu_torch.scm.container_manager import ContainerManager
from ozone_tpu_torch.scm.node_manager import NodeManager, NodeOperationalState
from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.scm.replication_manager import (
    ECReplicaCount,
    ReplicationManager,
)

log = logging.getLogger(__name__)


class DecommissionMonitor:
    def __init__(
        self,
        nodes: NodeManager,
        containers: ContainerManager,
        replication: ReplicationManager,
    ):
        self.nodes = nodes
        self.containers = containers
        self.replication = replication

    def start_decommission(self, dn_id: str) -> None:
        if self.nodes.get(dn_id) is None:
            raise KeyError(dn_id)
        self.nodes.set_op_state(dn_id, NodeOperationalState.DECOMMISSIONING)
        log.info("decommission started for %s", dn_id)

    def start_maintenance(self, dn_id: str) -> None:
        self.nodes.set_op_state(dn_id, NodeOperationalState.IN_MAINTENANCE)

    def recommission(self, dn_id: str) -> None:
        self.nodes.set_op_state(dn_id, NodeOperationalState.IN_SERVICE)

    def _node_drained(self, dn_id: str) -> bool:
        """Every container with a replica on dn_id is fully redundant
        without it (the admin monitor's sufficientlyReplicated check)."""
        for c in self.containers.containers():
            if dn_id not in c.replicas:
                continue
            if c.replication.type is ReplicationType.EC:
                if ECReplicaCount(c, self.nodes).missing_indexes:
                    return False
            else:
                live = [
                    d for d in c.replicas
                    if d != dn_id
                    and (n := self.nodes.get(d)) is not None
                    and n.op_state is NodeOperationalState.IN_SERVICE
                ]
                if len(live) < c.replication.factor:
                    return False
        return True

    def run_once(self) -> list[str]:
        """Finalize the drained DECOMMISSIONING nodes; returns them."""
        done = []
        for n in self.nodes.nodes():
            if n.op_state is not NodeOperationalState.DECOMMISSIONING:
                continue
            if self._node_drained(n.dn_id):
                self.nodes.set_op_state(
                    n.dn_id, NodeOperationalState.DECOMMISSIONED)
                log.info("decommission of %s complete", n.dn_id)
                done.append(n.dn_id)
        return done
