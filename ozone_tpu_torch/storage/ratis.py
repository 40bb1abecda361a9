"""Datanode Raft write path: pipeline consensus over the container store.

Port of `ozone_tpu/storage/ratis.py` (the reference's XceiverServerRatis,
one Raft server per datanode hosting one Raft group per pipeline, and
ContainerStateMachine's two-phase writes). As in the reference's
streaming write pipeline, chunk BYTES travel over the datapath (the
port's RPC or native lane) to every member and never enter the log;
the ORDERING and COMMIT of those writes go through the pipeline's Raft
group: create, write-chunk commit, put-block and close are proposed to
the leader, replicated and applied on every member. The commit apply
checks that the member holds the bytes the committed metadata describes
(a length probe; content checksums are the scanners' job); a member that
missed the data phase fails the apply with CHUNK_DATA_MISSING, marks
the container unhealthy, and the SCM's replication manager repairs it.
Snapshots carry only a marker (ContainerStateMachine.takeSnapshot):
container data is node-local and durable.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Optional

from ozone_tpu_torch.consensus.raft import (
    NotRaftLeaderError,
    RaftConfig,
    RaftNode,
)
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import BlockData, BlockID, StorageError

log = logging.getLogger(__name__)


class ContainerStateMachine:
    """Applies committed pipeline verbs to the local container store."""

    def __init__(self, dn: Datanode):
        self.dn = dn

    def apply(self, data: dict) -> dict:
        verb = data.get("verb")
        if verb == "create_container":
            try:
                self.dn.create_container(
                    int(data["container_id"]),
                    replica_index=int(data.get("replica_index", 0)),
                )
            except StorageError as e:
                if e.code != "CONTAINER_EXISTS":  # idempotent re-apply
                    raise
            return {"ok": True}
        if verb == "write_chunk_commit":
            return self._apply_write_chunk(data)
        if verb == "put_block":
            block = BlockData.from_json(data["block"])
            self.dn.put_block(block, sync=bool(data.get("sync", False)),
                              writer=data.get("writer"))
            return {"ok": True, "committed_length": block.length}
        if verb == "close_container":
            self.dn.close_container(int(data["container_id"]))
            return {"ok": True}
        raise StorageError("UNSUPPORTED_REQUEST", f"verb {verb!r}")

    def _apply_write_chunk(self, data: dict) -> dict:
        """Commit point of a chunk: the bytes must already be local (data
        phase); validate extent, never content (scanner territory)."""
        bid = BlockID.from_json(data["block_id"])
        offset = int(data["offset"])
        length = int(data["length"])
        c = self.dn.containers.get(bid.container_id)
        c.require_writable()
        have = c.chunks.block_length(bid)
        if have < offset + length:
            # this member missed the data phase (down/partitioned during
            # the stream): poison the replica, let replication repair it
            c.mark_unhealthy()
            raise StorageError(
                "CHUNK_DATA_MISSING",
                f"{bid} has {have} bytes locally, commit needs "
                f"{offset + length}",
            )
        return {"ok": True}

    # ------------------------------------------------------- snapshotting
    def snapshot(self) -> dict:
        # applied-index marker only (ContainerStateMachine.takeSnapshot
        # analog); container contents are already durable on disk
        return {"marker": "container-sm"}

    def restore(self, data) -> None:  # noqa: ARG002 - marker only
        return


class RatisXceiverServer:
    """Hosts one RaftNode per pipeline this datanode serves.

    The XceiverServerRatis analog: `join` creates/loads the group for a
    pipeline (SCM's create-pipeline command path), `submit` is the
    client-facing ordered write entry point (leader only), `watch` is
    watchForCommit (XceiverClientRatis.watchForCommit:297 — block until
    the write is applied on ALL members, or a MAJORITY).
    """

    def __init__(self, dn: Datanode, root: Path, node_address: str,
                 rpc_service=None,
                 config: RaftConfig = RaftConfig(),
                 auto_timers: bool = True, tls=None):
        self.dn = dn
        #: the datanode's identity on a mutual-TLS cluster: the groups'
        #: transports dial their peers with it
        self.tls = tls
        self.root = Path(root)
        self.node_address = node_address
        self.rpc_service = rpc_service  # net/raft_transport.RaftRpcService
        self.config = config
        #: False = tests drive elections/heartbeats deterministically via
        #: tick()/start_election() (the reference's no-real-clock style)
        self.auto_timers = auto_timers
        self._groups: dict[str, RaftNode] = {}
        self._transports: dict[str, object] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ groups
    def group_id(self, pipeline_id: int) -> str:
        return f"pipeline-{pipeline_id}"

    def join(self, pipeline_id: int, peers: dict[str, str],
             transport=None) -> RaftNode:
        """Join (or re-join after restart) a pipeline's raft group.

        `peers` maps every member datanode id -> RpcServer address
        (including this node). An RPC transport is built unless an
        explicit transport (tests: InProcessTransport) is given.
        """
        gid = self.group_id(pipeline_id)
        with self._lock:
            node = self._groups.get(gid)
            if node is not None:
                same = set(node.peer_ids) | {self.dn.id} == set(peers)
                if same:
                    if transport is None and gid in self._transports:
                        for pid, addr in peers.items():
                            self._transports[gid].set_peer(pid, addr)
                    return node
                # defense in depth: a served group with different
                # membership is stale (ids are persisted and never
                # reused, so this only happens on metadata loss) —
                # replace it rather than mis-address the new pipeline
                log.warning(
                    "%s: group %s membership changed %s -> %s; replacing",
                    self.dn.id, gid,
                    sorted({*node.peer_ids, self.dn.id}), sorted(peers))
                self._stop_group_locked(gid)
                import shutil

                shutil.rmtree(self.root / "ratis" / gid,
                              ignore_errors=True)
                node = None
            if transport is None:
                from ozone_tpu_torch.net.raft_transport import RpcRaftTransport

                transport = RpcRaftTransport(gid, dict(peers), tls=self.tls)
                self._transports[gid] = transport
            sm = ContainerStateMachine(self.dn)
            node = RaftNode(
                node_id=self.dn.id,
                peer_ids=[p for p in peers if p != self.dn.id],
                storage_dir=self.root / "ratis" / gid,
                apply_fn=sm.apply,
                snapshot_fn=sm.snapshot,
                restore_fn=sm.restore,
                config=self.config,
                transport=transport,
                metrics_name=f"raft.{self.dn.id}.{gid}",
            )
            self._groups[gid] = node
            if self.rpc_service is not None:
                self.rpc_service.register(gid, node)
            if self.auto_timers:
                node.start_timers()
            return node

    def _stop_group_locked(self, gid: str) -> None:
        node = self._groups.pop(gid, None)
        tr = self._transports.pop(gid, None)
        if node is not None:
            node.stop()
            if self.rpc_service is not None:
                self.rpc_service.unregister(gid)
        if tr is not None and hasattr(tr, "close"):
            tr.close()

    def leave(self, pipeline_id: int) -> None:
        with self._lock:
            self._stop_group_locked(self.group_id(pipeline_id))

    def get(self, pipeline_id: int) -> Optional[RaftNode]:
        with self._lock:
            return self._groups.get(self.group_id(pipeline_id))

    def pipelines(self) -> list[str]:
        with self._lock:
            return list(self._groups)

    # ----------------------------------------------------------- serving
    def submit(self, pipeline_id: int, request: dict,
               timeout: float = 30.0) -> dict:
        """Propose a pipeline verb on the local node (must be leader)."""
        node = self.get(pipeline_id)
        if node is None:
            raise StorageError("NO_SUCH_RAFT_GROUP",
                               f"pipeline {pipeline_id} not served here")
        try:
            result = node.propose(request, timeout=timeout)
        except NotRaftLeaderError as e:
            raise StorageError(
                "NOT_LEADER", e.leader_hint or ""
            ) from e
        except TimeoutError as e:
            raise StorageError("TIMEOUT", str(e)) from e
        if isinstance(result, Exception):
            if isinstance(result, StorageError):
                raise result
            raise StorageError("IO_EXCEPTION", str(result))
        return {"index": node.last_applied, **(result or {})}

    def watch(self, pipeline_id: int, index: int, policy: str = "ALL",
              timeout: float = 30.0) -> dict:
        """watchForCommit: block until `index` is APPLIED on ALL members
        (majority already held — propose() returned). Uses the apply
        watermark followers report in append responses, so a successful
        ALL watch means the write's effects are visible on every replica."""
        node = self.get(pipeline_id)
        if node is None:
            raise StorageError("NO_SUCH_RAFT_GROUP",
                               f"pipeline {pipeline_id} not served here")
        deadline = time.monotonic() + timeout
        while True:
            if not node.is_leader:
                raise StorageError("NOT_LEADER", node.leader_hint or "")
            if node._timer_thread is None:
                node.tick()  # deterministic mode: push commit + collect acks
            applied = [node.applied_index.get(p, 0) >= index
                       for p in node.peer_ids]
            if policy == "MAJORITY":
                need = (len(node.peer_ids) + 1) // 2  # +self = quorum
                done = sum(applied) >= need and node.last_applied >= index
            else:
                done = all(applied) and node.last_applied >= index
            if done:
                return {"index": index, "policy": policy}
            if time.monotonic() >= deadline:
                raise StorageError(
                    "TIMEOUT",
                    f"watch({index}, {policy}) on pipeline {pipeline_id}")
            if node._timer_thread is not None:
                time.sleep(0.01)

    def leader_of(self, pipeline_id: int) -> Optional[str]:
        node = self.get(pipeline_id)
        if node is None:
            return None
        return node.node_id if node.is_leader else node.leader_hint

    def stop(self) -> None:
        with self._lock:
            groups = list(self._groups.values())
            transports = list(self._transports.values())
            self._groups.clear()
            self._transports.clear()
        for n in groups:
            n.stop()
        for t in transports:
            if hasattr(t, "close"):
                t.close()
