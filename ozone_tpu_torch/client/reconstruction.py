"""Fleet-wide EC reconstruction storms: repair every EC container a dead
datanode held, concurrently, through one shared coordinator.

Port of `ozone_tpu/client/reconstruction.py`. When a datanode dies,
every EC container it held a replica of needs a decode; the SCM's
ReplicationManager repairs them one heartbeat command at a time, and
this module is the storm-shaped datapath for the same work: enumerate
every container the dead node touched, build the per-container
ReconstructionCommands the way `scm/replication_manager.py`'s
`_emit_reconstruction` does (first live source per index,
placement-chosen targets excluding every present holder), and run them
concurrently through one `ECReconstructionCoordinator`. Its readers
submit their decode batches to the shared codec service (the "bulk"
class), where batches of different containers with the same erasure
pattern coalesce into shared launches of the fused kernel on one device.

The reference spreads those batches over a device mesh through its mesh
executor; the port has no mesh yet, so `executor` must be None and the
report's `mesh_*` fields stay 0, as the reference reports for a storm
with no mesh.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

from ozone_tpu_torch.codec import lrc_math
from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.storage.ids import ContainerState
from ozone_tpu_torch.storage.reconstruction import (
    ECReconstructionCoordinator,
    ReconstructionCommand,
)
from ozone_tpu_torch.utils.checksum import ChecksumType
from ozone_tpu_torch.utils.metrics import registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

METRICS = registry("client.reconstruction")


@dataclass
class StormReport:
    """What one `repair_datanode` pass did."""

    dead_dn: str
    containers_planned: int = 0
    containers_repaired: int = 0
    containers_failed: int = 0
    containers_unrecoverable: int = 0
    elapsed_s: float = 0.0
    #: mesh-executor counter deltas across the storm: zeros, since the
    #: port's storm runs on one device with no mesh executor
    mesh_dispatches: int = 0
    mesh_stripes: int = 0
    mesh_coalesced_ops: int = 0
    mesh_multi_op_dispatches: int = 0
    mesh_max_inflight: int = 0
    failures: list[tuple[int, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (self.containers_failed == 0
                and self.containers_repaired == self.containers_planned)


class ReconstructionStorm:
    """Repair every EC container a dead datanode held.

    `scm` is a StorageContainerManager (its .containers, .nodes and
    .placement drive planning); `clients` the DatanodeClientFactory
    reaching the surviving nodes. `executor` takes only None until the
    port has a mesh executor. The decodes run on `device` ("cuda"
    launches the fused kernel and raises when CUDA is absent; "cpu" runs
    its plain version).
    """

    def __init__(self, scm, clients, executor=None,
                 checksum: ChecksumType = ChecksumType.CRC32C,
                 bytes_per_checksum: int = 16 * 1024,
                 max_parallel_containers: int = 4,
                 max_parallel_blocks: int = 2,
                 device="cuda"):
        if executor is not None:
            raise ValueError("the port has no mesh executor; pass executor=None")
        self.scm = scm
        self.clients = clients
        self.executor = None
        #: containers repairing at once: each streams its own survivor
        #: reads and target writes while their decode batches meet in the
        #: codec service's bulk lane, and this concurrency fills them
        self.max_parallel_containers = max(1, int(max_parallel_containers))
        self.coordinator = ECReconstructionCoordinator(
            clients,
            checksum=checksum,
            bytes_per_checksum=bytes_per_checksum,
            max_parallel_blocks=max_parallel_blocks,
            device=device,
        )

    # ------------------------------------------------------------- plan
    def plan(self, dead_dn_id: str) -> list[ReconstructionCommand]:
        """ReconstructionCommands for every EC container with a replica
        on the dead node (in the SCM's replica map, or among those the SCM
        forgot when it declared the node dead), built the
        `_emit_reconstruction` way: first
        surviving holder per index as source, placement-chosen targets
        excluding every present holder and the dead node. Containers with
        too few survivors are skipped (and counted by the caller as
        unrecoverable): a storm must never wedge on a lost cause.

        Commands come back sorted by recoverability, fewest surviving
        indexes first, container id as the tiebreak: the stripes closest
        to losing data repair earliest."""
        cmds: list[tuple[int, ReconstructionCommand]] = []
        # once the SCM has declared the node dead it has forgotten the
        # node's replicas (DeadNodeHandler), and remembers which they were
        forgotten = set(self.scm.dead_node_containers.get(dead_dn_id, ()))
        for c in self.scm.containers.containers():
            if c.replication.type is not ReplicationType.EC:
                continue
            if c.state is ContainerState.DELETED:
                continue
            if dead_dn_id not in c.replicas and c.id not in forgotten:
                continue
            present: dict[int, list[str]] = {}
            for dn_id, r in c.replicas.items():
                if dn_id == dead_dn_id:
                    continue
                if r.state in ("UNHEALTHY", "DELETED", "INVALID"):
                    continue
                if self.scm.nodes.get(dn_id) is None:
                    continue
                present.setdefault(r.replica_index, []).append(dn_id)
            ec = c.replication.ec
            missing = sorted(set(range(1, ec.all_units + 1)) - set(present))
            if not missing:
                continue  # the dead replica's index survives elsewhere
            if ec.codec == "lrc":
                # LRC recoverability is pattern-shaped, not a survivor
                # count: ask the repair planner (0-based indexes)
                try:
                    lrc_math.plan_valid(ec, [i - 1 for i in missing],
                                        [i - 1 for i in present])
                    recoverable = True
                except ValueError:
                    recoverable = False
            else:
                recoverable = len(present) >= ec.data_units
            if not recoverable:
                METRICS.counter("unrecoverable").inc()
                log.warning("storm: container %s unrecoverable (%d/%d indexes "
                            "survive)", c.id, len(present), ec.data_units)
                continue
            sources = {i: dns[0] for i, dns in present.items()}
            exclude = [dn for dns in present.values() for dn in dns]
            exclude.append(dead_dn_id)
            try:
                chosen = self.scm.placement.choose(len(missing), exclude)
            except Exception:  # noqa: BLE001 - placement exhausted: skip, report
                METRICS.counter("placement_failures").inc()
                log.exception("storm: no targets for container %s", c.id)
                continue
            cmds.append((len(present), ReconstructionCommand(
                container_id=c.id,
                replication=ec,
                sources=sources,
                targets={i: n.dn_id for i, n in zip(missing, chosen)},
            )))
        cmds.sort(key=lambda sc: (sc[0], sc[1].container_id))
        return [cmd for _survivors, cmd in cmds]

    # ------------------------------------------------------------ drive
    def repair_datanode(self, dead_dn_id: str) -> StormReport:
        """The storm: plan, then repair the containers concurrently
        through the shared coordinator."""
        report = StormReport(dead_dn=dead_dn_id)
        unrec0 = METRICS.counter("unrecoverable").value
        cmds = self.plan(dead_dn_id)
        report.containers_planned = len(cmds)
        report.containers_unrecoverable = int(
            METRICS.counter("unrecoverable").value - unrec0)
        if not cmds:
            return report
        t0 = time.monotonic()
        METRICS.counter("storms").inc()
        METRICS.gauge("containers_in_flight").set(0)

        def repair(cmd: ReconstructionCommand) -> Optional[str]:
            with Tracer.instance().span("storm:container",
                                        container=cmd.container_id,
                                        dead_dn=dead_dn_id):
                try:
                    self.coordinator.reconstruct_container_group(cmd)
                    return None
                except Exception as e:  # noqa: BLE001 - per-container fault isolation
                    log.exception("storm: container %s repair failed",
                                  cmd.container_id)
                    return f"{type(e).__name__}: {e}"

        with ThreadPoolExecutor(
                max_workers=self.max_parallel_containers,
                thread_name_prefix="storm") as pool:
            for cmd, err in zip(cmds, pool.map(repair, cmds)):
                if err is None:
                    report.containers_repaired += 1
                    METRICS.counter("containers_repaired").inc()
                else:
                    report.containers_failed += 1
                    METRICS.counter("containers_failed").inc()
                    report.failures.append((cmd.container_id, err))
        report.elapsed_s = time.monotonic() - t0
        return report
