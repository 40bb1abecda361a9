"""SCM safemode: block allocation gated on cluster readiness.

Port of `ozone_tpu/scm/safemode.py` (the reference's SCMSafeModeManager
and its exit rules): a minimum of registered datanodes, and the fraction
of closed containers with a reported replica. Exit is one-way; the
operator's `force` (`admin safemode enter|exit`) overrides the rules
until it is cleared with None. The reference's pipeline rules, which
gate on the pipelines its SCM store recovers at startup, are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

from ozone_tpu_torch.scm.container_manager import ContainerManager
from ozone_tpu_torch.scm.node_manager import NodeManager
from ozone_tpu_torch.storage.ids import ContainerState


class SafeModeError(Exception):
    pass


@dataclass
class SafeModeConfig:
    min_datanodes: int = 1
    container_replica_fraction: float = 0.99


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

    def force(self, in_safemode: bool | None) -> None:
        """The operator's override (`ozone admin safemode enter|exit`)."""
        self._forced = in_safemode

    def status(self) -> dict:
        relevant = [
            c
            for c in self.containers.containers()
            if c.state in (ContainerState.CLOSED, ContainerState.QUASI_CLOSED)
        ]
        return {
            "datanodes": self.nodes.node_count(),
            "datanodes_required": self.config.min_datanodes,
            "containers_with_replica": sum(1 for c in relevant if c.replicas),
            "containers_total": len(relevant),
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
        self._exited = True  # rules passed: exit is permanent
        return False

    def check_allocation_allowed(self) -> None:
        """Raises while in safemode (BlockManagerImpl's safemode check)."""
        if self.in_safemode():
            raise SafeModeError(f"SCM is in safemode: {self.status()}")
