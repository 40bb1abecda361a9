"""SCM safemode: block allocation gated on cluster readiness.

Port of `ozone_tpu/scm/safemode.py` (the reference's SCMSafeModeManager
and its exit rules): DataNodeSafeModeRule (a minimum of registered
datanodes), ContainerSafeModeRule (the fraction of closed containers
with a reported replica), HealthyPipelineSafeModeRule (the fraction of
the OPEN pipelines the SCM store recovered at startup whose members are
all back HEALTHY, default 0.10) and OneReplicaPipelineSafeModeRule (the
fraction of them with at least one member back, default 0.90). A
pipeline made after startup never gates, and one closed or removed
since stops gating. Exit is one-way; the operator's `force` (`admin
safemode enter|exit`) overrides the rules until it is cleared with None.
"""

from __future__ import annotations

from dataclasses import dataclass

from ozone_tpu_torch.scm.container_manager import ContainerManager
from ozone_tpu_torch.scm.node_manager import NodeManager, NodeState
from ozone_tpu_torch.scm.pipeline import PipelineState
from ozone_tpu_torch.storage.ids import ContainerState


class SafeModeError(Exception):
    pass


@dataclass
class SafeModeConfig:
    min_datanodes: int = 1
    container_replica_fraction: float = 0.99
    # the reference's defaults: hdds.scm.safemode.healthy.pipeline.pct
    # 0.10, hdds.scm.safemode.atleast.one.node.reported.pipeline.pct 0.90
    healthy_pipeline_fraction: float = 0.10
    one_replica_pipeline_fraction: float = 0.90


class SafeModeManager:
    def __init__(
        self,
        nodes: NodeManager,
        containers: ContainerManager,
        config: SafeModeConfig = SafeModeConfig(),
    ):
        self.nodes = nodes
        self.containers = containers
        self.config = config
        self._forced: bool | None = None  # the operator's override
        # exit is one-way: once the rules pass, later node flaps must not
        # re-gate allocation
        self._exited = False
        # the pipeline rules gate on the OPEN pipelines recovered from the
        # store at startup (recovery marks retired ones CLOSED)
        self._initial_pipeline_ids = {
            p.id for p in containers.pipelines()
            if p.state is PipelineState.OPEN
        }

    def force(self, in_safemode: bool | None) -> None:
        """The operator's override (`ozone admin safemode enter|exit`)."""
        self._forced = in_safemode

    def _pipeline_counts(self) -> tuple[int, int, int]:
        """(total, all members HEALTHY, at least one member back) over the
        startup-recovered pipelines that are still OPEN."""
        total = healthy = one = 0
        for p in self.containers.pipelines():
            if (p.id not in self._initial_pipeline_ids
                    or p.state is not PipelineState.OPEN):
                continue
            total += 1
            states = []
            for dn_id in p.nodes:
                n = self.nodes.get(dn_id)
                states.append(n.state if n is not None else None)
            if states and all(st is NodeState.HEALTHY for st in states):
                healthy += 1
            if any(st is not None for st in states):
                one += 1
        return total, healthy, one

    def status(self) -> dict:
        relevant = [
            c
            for c in self.containers.containers()
            if c.state in (ContainerState.CLOSED, ContainerState.QUASI_CLOSED)
        ]
        total_p, healthy_p, one_p = self._pipeline_counts()
        return {
            "datanodes": self.nodes.node_count(),
            "datanodes_required": self.config.min_datanodes,
            "containers_with_replica": sum(1 for c in relevant if c.replicas),
            "containers_total": len(relevant),
            "pipelines_total": total_p,
            "pipelines_healthy": healthy_p,
            "pipelines_with_member": one_p,
        }

    def in_safemode(self) -> bool:
        if self._forced is not None:
            return self._forced
        if self._exited:
            return False
        s = self.status()
        if s["datanodes"] < s["datanodes_required"]:
            return True
        if s["containers_total"]:
            frac = s["containers_with_replica"] / s["containers_total"]
            if frac < self.config.container_replica_fraction:
                return True
        if s["pipelines_total"]:
            if (s["pipelines_healthy"] / s["pipelines_total"]
                    < self.config.healthy_pipeline_fraction):
                return True
            if (s["pipelines_with_member"] / s["pipelines_total"]
                    < self.config.one_replica_pipeline_fraction):
                return True
        self._exited = True  # rules passed: exit is permanent
        return False

    def check_allocation_allowed(self) -> None:
        """Raises while in safemode (BlockManagerImpl's safemode check)."""
        if self.in_safemode():
            raise SafeModeError(f"SCM is in safemode: {self.status()}")
