"""SCM container manager: lifecycle, replica tracking, the pool of open
containers per replication scheme, and block allocation.

Port of `ozone_tpu/scm/container_manager.py` (the reference's
ContainerManagerImpl lifecycle OPEN -> CLOSING -> CLOSED -> DELETED,
replica maps fed by container reports, BlockManagerImpl.allocateBlock
and the writable-container providers: a pool of open containers, one
pipeline each, a new container when none fits). Left out for later
slices: the SCM store (persistence and recovery), the HA id source and
mutation records, the pipeline lifecycle hooks, and the stateful-service
rows. Of the lifecycle hooks, `on_container_closing` is ported: the
metadata daemon (`net/daemons.py`) turns it into close commands to the
replicas.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.scm.node_manager import NodeManager
from ozone_tpu_torch.scm.pipeline import (
    Pipeline,
    PipelineState,
    ReplicationConfig,
)
from ozone_tpu_torch.scm.placement import PlacementPolicy
from ozone_tpu_torch.storage.ids import ContainerState

log = logging.getLogger(__name__)


@dataclass
class ContainerReplica:
    dn_id: str
    state: str = "OPEN"
    replica_index: int = 0  # 1-based for EC, 0 for replicated containers
    block_count: int = 0
    used_bytes: int = 0


@dataclass
class ContainerInfo:
    id: int
    replication: ReplicationConfig
    pipeline: Optional[Pipeline]
    state: ContainerState = ContainerState.OPEN
    used_bytes: int = 0
    replicas: dict[str, ContainerReplica] = field(default_factory=dict)


class ContainerManager:
    def __init__(
        self,
        nodes: NodeManager,
        placement: PlacementPolicy,
        container_size: int = 5 * 1024 * 1024 * 1024,
    ):
        self.nodes = nodes
        self.placement = placement
        self.container_size = container_size
        self._containers: dict[int, ContainerInfo] = {}
        self._pipelines: dict[int, Pipeline] = {}
        self._next_cid = 1
        self._next_lid = 1
        # open writable containers by replication-scheme string
        self._writable: dict[str, list[int]] = {}
        self._lock = threading.RLock()
        #: callable(ContainerInfo) run when a container goes OPEN -> CLOSING
        self.on_container_closing = None

    # --------------------------------------------------------------- queries
    def get(self, container_id: int) -> ContainerInfo:
        return self._containers[container_id]

    def get_or_none(self, container_id: int) -> Optional[ContainerInfo]:
        return self._containers.get(container_id)

    def containers(self) -> list[ContainerInfo]:
        return list(self._containers.values())

    # --------------------------------------------------------------- alloc
    def _issue_block_id(self) -> int:
        with self._lock:
            lid = self._next_lid
            self._next_lid += 1
            return lid

    def _allocate_container(self, replication: ReplicationConfig,
                            excluded: list[str]) -> ContainerInfo:
        chosen = self.placement.choose(replication.required_nodes, excluded)
        pipe = Pipeline(replication, [n.dn_id for n in chosen])
        self._pipelines[pipe.id] = pipe
        c = ContainerInfo(self._next_cid, replication, pipe)
        self._next_cid += 1
        self._containers[c.id] = c
        return c

    def allocate_block(
        self,
        replication: ReplicationConfig,
        block_size: int,
        excluded: Optional[list[str]] = None,
        excluded_containers: Optional[list[int]] = None,
    ) -> BlockGroup:
        """Find or create an open container on a healthy pipeline and issue
        a new block id in it. `excluded_containers` are the reference
        ExcludeList's container ids: a client that just saw
        CONTAINER_CLOSED must not be handed the same container back
        before its report lands."""
        excluded = excluded or []
        excluded_containers = set(excluded_containers or ())
        lid = self._issue_block_id()
        with self._lock:
            pool = self._writable.setdefault(str(replication), [])
            for cid in list(pool):
                c = self._containers.get(cid)
                if c is None or c.state is not ContainerState.OPEN:
                    pool.remove(cid)
                    continue
                if cid in excluded_containers:
                    continue
                if any(n in excluded for n in c.pipeline.nodes):
                    continue
                if c.used_bytes + block_size > self.container_size:
                    # full: close it (the reference's close threshold)
                    self.finalize_container(cid)
                    pool.remove(cid)
                    continue
                c.used_bytes += block_size
                return BlockGroup(container_id=cid, local_id=lid,
                                  pipeline=c.pipeline)
            c = self._allocate_container(replication, excluded)
            pool.append(c.id)
            c.used_bytes += block_size
            return BlockGroup(container_id=c.id, local_id=lid,
                              pipeline=c.pipeline)

    # --------------------------------------------------------------- lifecycle
    def _close_pipeline(self, c: ContainerInfo) -> None:
        """A container leaving OPEN retires its (1:1) pipeline."""
        p = c.pipeline
        if p is None or p.state is PipelineState.CLOSED:
            return
        p.state = PipelineState.CLOSED
        self._pipelines.pop(p.id, None)

    def finalize_container(self, container_id: int) -> None:
        """OPEN -> CLOSING; the pipeline stays live until the replicas
        report CLOSED (mark_closed)."""
        c = self._containers[container_id]
        if c.state is ContainerState.OPEN:
            c.state = ContainerState.CLOSING
            if self.on_container_closing is not None:
                self.on_container_closing(c)

    def mark_closed(self, container_id: int) -> None:
        c = self._containers[container_id]
        c.state = ContainerState.CLOSED
        self._close_pipeline(c)

    # --------------------------------------------------------------- reports
    def process_container_report(self, dn_id: str, report: list[dict]) -> None:
        """Ingest a full container report from a datanode heartbeat."""
        seen = set()
        for r in report:
            cid = int(r["container_id"])
            seen.add(cid)
            c = self._containers.get(cid)
            if c is None:
                continue  # a container this SCM never allocated
            c.replicas[dn_id] = ContainerReplica(
                dn_id=dn_id,
                state=r["state"],
                replica_index=int(r.get("replica_index", 0)),
                block_count=int(r.get("block_count", 0)),
                used_bytes=int(r.get("used_bytes", 0)),
            )
            if r["state"] == "UNHEALTHY" \
                    and c.state is ContainerState.OPEN:
                # an unhealthy replica of an OPEN container: stop
                # allocating into it; writers roll to a fresh container and
                # the replication manager repairs the replica once closed
                log.warning("container %d has unhealthy replica on %s; "
                            "closing", cid, dn_id)
                with self._lock:
                    self.finalize_container(cid)
        # drop replicas this datanode no longer reports
        for c in self._containers.values():
            if dn_id in c.replicas and c.id not in seen:
                del c.replicas[dn_id]

    def remove_replicas_of_node(self, dn_id: str) -> list[int]:
        """Node death: forget its replicas; return affected container ids."""
        affected = []
        for c in self._containers.values():
            if dn_id in c.replicas:
                del c.replicas[dn_id]
                affected.append(c.id)
        for p in self._pipelines.values():
            if dn_id in p.nodes and p.state is PipelineState.OPEN:
                p.state = PipelineState.CLOSED
        return affected
