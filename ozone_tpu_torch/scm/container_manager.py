"""SCM container manager: lifecycle, replica tracking, the pool of open
containers per replication scheme, and block allocation.

Port of `ozone_tpu/scm/container_manager.py` (the reference's
ContainerManagerImpl lifecycle OPEN -> CLOSING -> CLOSED -> DELETED,
replica maps fed by container reports, BlockManagerImpl.allocateBlock
and the writable-container providers: a pool of open containers, one
pipeline each, a new container when none fits). With `db_path` the rows
and id counters persist in the SCM store (`scm/scm_store.py`) and come
back on restart. Under HA (`scm/ha.py`) every durable mutation goes to
`mutation_listener` as a decision record the ring replicates, followers
apply records with `apply_mutation`, a snapshot ships `snapshot_state`,
and the ids come from `id_source`, quorum-committed ranges. The
lifecycle hooks (`on_pipeline_created`, `on_pipeline_closed`,
`on_container_closing`) let the metadata daemon (`net/daemons.py`) turn
pipelines into datanode raft groups and closes into close commands.
Left out for later slices: the stateful-service rows (the balancer) and
the node operational states (decommission).
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
    _pipeline_ids,
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
        db_path=None,
    ):
        self.nodes = nodes
        self.placement = placement
        self.container_size = container_size
        self._containers: dict[int, ContainerInfo] = {}
        self._pipelines: dict[int, Pipeline] = {}
        self._next_cid = 1
        self._next_lid = 1
        # replicated pipeline-id floor (HA only; standalone pipelines draw
        # from the process-local allocator)
        self._next_pid = 1
        #: HA commit-first id source (scm/sequence_id.py): when set,
        #: container, block and pipeline ids come only from ranges the
        #: ring already committed; None = the persisted counters
        self.id_source = None
        # open writable containers by replication-scheme string
        self._writable: dict[str, list[int]] = {}
        self._lock = threading.RLock()
        #: HA hook, callable(row, counters) after every durable mutation:
        #: the leader ships these decision records through the ring
        self.mutation_listener = None
        #: pipeline lifecycle hooks: the daemon turns them into
        #: join-pipeline / leave-pipeline commands to the members
        self.on_pipeline_created = None
        self.on_pipeline_closed = None
        #: callable(ContainerInfo) run when a container goes OPEN -> CLOSING
        self.on_container_closing = None
        self._db = None
        if db_path is not None:
            from ozone_tpu_torch.scm.scm_store import ScmStore

            self._db = ScmStore(db_path)
            self._recover()

    @staticmethod
    def _pipeline_from_row(row: dict) -> Pipeline:
        """Rebuild a persisted pipeline keeping its cluster-assigned id
        (datanode raft groups are named by it), and keep the allocator
        ahead of every restored id."""
        repl = ReplicationConfig.parse(row["replication"])
        kw = {}
        if row.get("pipeline_id") is not None:
            kw["id"] = int(row["pipeline_id"])
        p = Pipeline(repl, list(row["nodes"]), **kw)
        _pipeline_ids.advance_past(p.id)
        return p

    def _recover(self) -> None:
        state = self._db.load()
        for c in state["containers"]:
            repl = ReplicationConfig.parse(c["replication"])
            cstate = ContainerState(c["state"])
            pipe = self._pipelines.get(
                int(c["pipeline_id"])
                if c.get("pipeline_id") is not None else -1)
            if pipe is None:
                pipe = self._pipeline_from_row(c)
                # pipeline rows are not persisted on their own: a retired
                # pipeline comes back CLOSED until an attached container
                # proves it still carries writes
                pipe.state = PipelineState.CLOSED
                self._pipelines[pipe.id] = pipe
            if cstate in (ContainerState.OPEN, ContainerState.CLOSING):
                pipe.state = PipelineState.OPEN
            info = ContainerInfo(c["id"], repl, pipe, state=cstate,
                                 used_bytes=int(c["used_bytes"]))
            self._containers[info.id] = info
            if info.state is ContainerState.OPEN:
                self._writable.setdefault(str(repl), []).append(info.id)
        self._next_cid = state["next_container_id"]
        self._next_lid = state["next_local_id"]
        self._next_pid = max(
            int(state.get("pipeline_floor", 1)),
            max((p.id for p in self._pipelines.values()), default=0) + 1)

    def _row(self, c: ContainerInfo) -> dict:
        return {
            "id": c.id,
            "replication": str(c.replication),
            "nodes": c.pipeline.nodes if c.pipeline else [],
            "pipeline_id": c.pipeline.id if c.pipeline else None,
            "state": c.state.value,
            "used_bytes": c.used_bytes,
        }

    def _persist(self, c: ContainerInfo) -> None:
        row = self._row(c)
        counters = (self._next_cid, self._next_lid)
        if self._db is not None:
            self._db.save_container(row, counters=counters)
        if self.mutation_listener is not None:
            self.mutation_listener(row, counters)

    def apply_mutation(self, row: dict, counters: tuple[int, int]) -> None:
        """Follower-side deterministic apply of a leader's decision record
        (SCMStateMachine.applyTransaction): upsert the container row and
        advance the id counters."""
        with self._lock:
            c = self._containers.get(int(row["id"]))
            if c is None:
                repl = ReplicationConfig.parse(row["replication"])
                pipe = self._pipeline_from_row(row)
                self._pipelines[pipe.id] = pipe
                c = ContainerInfo(int(row["id"]), repl, pipe)
                self._containers[c.id] = c
            c.state = ContainerState(row["state"])
            c.used_bytes = int(row["used_bytes"])
            # a pipeline is live iff an attached container still takes
            # writes, on every recovery path
            self._refresh_pipeline_state(c.pipeline)
            pool = self._writable.setdefault(str(c.replication), [])
            if c.state is ContainerState.OPEN:
                if c.id not in pool:
                    pool.append(c.id)
            elif c.id in pool:
                pool.remove(c.id)
            self._next_cid = max(self._next_cid, int(counters[0]))
            self._next_lid = max(self._next_lid, int(counters[1]))
            if self._db is not None:
                self._db.save_container(
                    row, counters=(self._next_cid, self._next_lid))

    def _refresh_pipeline_state(self, pipe) -> None:
        live = any(
            cc.pipeline.id == pipe.id
            and cc.state in (ContainerState.OPEN, ContainerState.CLOSING)
            for cc in self._containers.values())
        pipe.state = PipelineState.OPEN if live else PipelineState.CLOSED

    def snapshot_state(self) -> dict:
        """Full durable-state dump for follower bootstrap (the
        SCMSnapshotProvider checkpoint)."""
        with self._lock:
            return {
                "containers": [self._row(c)
                               for c in self._containers.values()],
                "counters": [self._next_cid, self._next_lid],
                "pipeline_floor": self._next_pid,
                "service_states": {},
            }

    def install_snapshot(self, snap: dict) -> None:
        """Replace-all install of a shipped checkpoint: containers absent
        from it are dropped (a deposed leader resyncing may hold rows the
        quorum never accepted), then every row is upserted. Replica soft
        state of surviving containers is kept; heartbeats rebuild it."""
        with self._lock:
            keep = {int(r["id"]) for r in snap["containers"]}
            for cid in [c for c in self._containers if c not in keep]:
                c = self._containers.pop(cid)
                if c.pipeline is not None:
                    self._pipelines.pop(c.pipeline.id, None)
            for pool in self._writable.values():
                pool[:] = [cid for cid in pool if cid in keep]
        for row in snap["containers"]:
            self.apply_mutation(row, tuple(snap["counters"]))
        with self._lock:
            self._next_cid = max(self._next_cid, int(snap["counters"][0]))
            self._next_lid = max(self._next_lid, int(snap["counters"][1]))
            self._next_pid = max(
                self._next_pid, int(snap.get("pipeline_floor", 1)),
                max((p.id for p in self._pipelines.values()), default=0)
                + 1)

    # --------------------------------------------------------------- queries
    def get(self, container_id: int) -> ContainerInfo:
        return self._containers[container_id]

    def get_or_none(self, container_id: int) -> Optional[ContainerInfo]:
        return self._containers.get(container_id)

    def containers(self) -> list[ContainerInfo]:
        return list(self._containers.values())

    def pipelines(self) -> list[Pipeline]:
        return list(self._pipelines.values())

    # --------------------------------------------------------------- alloc
    def peek_id_floor(self, kind: str) -> int:
        """Current committed floor of an id kind: the leader reads it to
        compose an absolute range-reservation record."""
        with self._lock:
            return {"container": self._next_cid,
                    "block": self._next_lid,
                    "pipeline": self._next_pid}[kind]

    def reserve_id_range(self, kind: str, lo: int, hi: int):
        """Deterministic apply of a commit-first range reservation. The
        record carries absolute bounds, so a re-apply is idempotent and
        every replica reaches the same floor; a stale record (lo below
        the floor) is refused with None on every replica and the
        proposer retries. Emits no mutation record: the reservation is
        the replicated record."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            raise ValueError(f"bad reservation [{lo}, {hi})")
        with self._lock:
            if kind == "container":
                if lo < self._next_cid:
                    return None
                self._next_cid = hi
            elif kind == "block":
                if lo < self._next_lid:
                    return None
                self._next_lid = hi
            elif kind == "pipeline":
                if lo < self._next_pid:
                    return None
                self._next_pid = hi
            else:
                raise ValueError(f"unknown id kind {kind!r}")
            if self._db is not None:
                self._db.save_counters((self._next_cid, self._next_lid),
                                       pipeline_floor=self._next_pid)
            return [lo, hi]

    def _issue_block_id(self) -> int:
        if self.id_source is not None:
            # commit-first: may block on a ring round trip, so it runs
            # outside the container lock (the apply path takes it)
            return self.id_source.next("block")
        with self._lock:
            lid = self._next_lid
            self._next_lid += 1
            return lid

    def _create_pipeline(self, replication: ReplicationConfig,
                         excluded: list[str],
                         pipeline_id: Optional[int] = None) -> Pipeline:
        chosen = self.placement.choose(replication.required_nodes, excluded)
        kw = {"id": pipeline_id} if pipeline_id is not None else {}
        p = Pipeline(replication, [n.dn_id for n in chosen], **kw)
        if pipeline_id is not None:
            _pipeline_ids.advance_past(pipeline_id)
        self._pipelines[p.id] = p
        if self.on_pipeline_created is not None:
            try:
                self.on_pipeline_created(p)
            except Exception:  # allocation must not fail on the hook
                log.exception("pipeline-created hook failed for %s", p.id)
        return p

    def _allocate_container(self, replication: ReplicationConfig,
                            excluded: list[str],
                            container_id: Optional[int] = None,
                            pipeline_id: Optional[int] = None
                            ) -> ContainerInfo:
        pipe = self._create_pipeline(replication, excluded,
                                     pipeline_id=pipeline_id)
        if container_id is None:
            container_id = self._next_cid
            self._next_cid += 1
        c = ContainerInfo(container_id, replication, pipe)
        self._containers[c.id] = c
        # no _persist: allocate_block persists the final row right after
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
        before its report lands. Under HA (id_source set) every id is
        drawn from a quorum-committed range before it is exposed, and
        the reservations happen outside the container lock: the ring's
        apply path takes that lock."""
        excluded = excluded or []
        excluded_containers = set(excluded_containers or ())
        lid = self._issue_block_id()
        # (cid, pid, issue epoch) pre-issued outside the container lock
        new_ids: Optional[tuple[int, int, int]] = None
        while True:
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
                    self._persist(c)
                    if new_ids is not None and self.id_source is not None:
                        # speculative ids unused: back to the free list;
                        # the epoch makes it a no-op after a step-down
                        self.id_source.release("container", new_ids[0],
                                               epoch=new_ids[2])
                        self.id_source.release("pipeline", new_ids[1],
                                               epoch=new_ids[2])
                    return BlockGroup(container_id=cid, local_id=lid,
                                      pipeline=c.pipeline)
                if self.id_source is None:
                    c = self._allocate_container(replication, excluded)
                elif new_ids is not None:
                    c = self._allocate_container(
                        replication, excluded,
                        container_id=new_ids[0], pipeline_id=new_ids[1])
                else:
                    c = None  # ids first: reserve outside the lock, retry
                if c is not None:
                    pool.append(c.id)
                    c.used_bytes += block_size
                    self._persist(c)
                    return BlockGroup(container_id=c.id, local_id=lid,
                                      pipeline=c.pipeline)
            ep = self.id_source.epoch
            new_ids = (self.id_source.next("container"),
                       self.id_source.next("pipeline"), ep)

    # --------------------------------------------------------------- lifecycle
    def _close_pipeline(self, c: ContainerInfo) -> None:
        """A container leaving OPEN retires its (1:1) pipeline: writes
        stop, and the members may drop the raft group."""
        p = c.pipeline
        if p is None or p.state is PipelineState.CLOSED:
            return
        p.state = PipelineState.CLOSED
        self._pipelines.pop(p.id, None)
        if self.on_pipeline_closed is not None:
            try:
                self.on_pipeline_closed(p)
            except Exception:  # the lifecycle must not fail on the hook
                log.exception("pipeline-closed hook failed for %s", p.id)

    def finalize_container(self, container_id: int) -> None:
        """OPEN -> CLOSING. The pipeline stays live through CLOSING: a
        RATIS close is ordered through the pipeline's raft ring after
        the writes in flight; the pipeline retires at mark_closed."""
        c = self._containers[container_id]
        if c.state is ContainerState.OPEN:
            c.state = ContainerState.CLOSING
            self._persist(c)
            self._fire_container_closing(c)

    def _fire_container_closing(self, c: ContainerInfo) -> None:
        if self.on_container_closing is not None:
            try:
                self.on_container_closing(c)
            except Exception:  # the lifecycle must not fail on the hook
                log.exception("container-closing hook failed for %s", c.id)

    def mark_closed(self, container_id: int) -> None:
        c = self._containers[container_id]
        c.state = ContainerState.CLOSED
        self._persist(c)
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
