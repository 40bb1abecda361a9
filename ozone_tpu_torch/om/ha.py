"""OM high availability: the replicated request log and the failover
client.

Port of `ozone_tpu/om/ha.py` (the reference's OM HA stack:
OzoneManagerRatisServer.submitRequest ships post-preExecute requests
through Raft, OzoneManagerStateMachine.applyTransaction applies them on
every replica, clients fail over through the OMFailoverProxyProvider).
Two consensus modes share the request lifecycle (preExecute on the
leader, the serialized request through a durable ordered log, the
deterministic apply everywhere):

- `RaftOzoneManager`: quorum consensus (`consensus/raft.py`), elections
  with terms, the quorum-committed log, conflict repair and snapshot
  bootstrap;
- `ReplicatedOzoneManager`: single-leader synchronous replication with
  operator-driven `promote()` failover.

Both keep a durable JSONL log per replica, fsync'd on append and
replayed on restart. The daemons' metadata ring
(`consensus/meta_ring.py`) replicates the OM and the SCM together.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Any, Optional

from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.om import OzoneManager

log = logging.getLogger(__name__)


class RequestLog:
    """Durable ordered request log (Raft-log stand-in)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a+")
        self._lock = threading.Lock()
        self._index = sum(1 for _ in open(self.path))

    @property
    def index(self) -> int:
        return self._index

    def append(self, entry: dict) -> int:
        with self._lock:
            self._f.write(json.dumps(entry, separators=(",", ":")) + "\n")
            self._f.flush()
            import os

            os.fsync(self._f.fileno())
            self._index += 1
            return self._index

    def read_from(self, start: int = 0) -> list[dict]:
        with self._lock:
            self._f.flush()
        out = []
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i >= start and line.strip():
                    out.append(json.loads(line))
        return out

    def close(self) -> None:
        self._f.close()


class ReplicatedOzoneManager:
    """One OM replica: leader accepts writes, followers apply the log."""

    def __init__(self, om: OzoneManager, log_path: Path, om_id: str,
                 is_leader: bool = False):
        self.om = om
        self.om_id = om_id
        self.is_leader = is_leader
        self.wal = RequestLog(log_path)
        self.applied_index = 0
        self.peers: list["ReplicatedOzoneManager"] = []
        self._lock = threading.RLock()
        self._recover()

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:
        """Replay the local log onto the store (idempotent: requests that
        already applied raise OMErrors which are ignored during replay —
        the cache/DB state converges because applies are deterministic)."""
        entries = self.wal.read_from(0)
        for e in entries:
            try:
                rq.OMRequest.from_json(e["request"]).apply(self.om.store)
            except rq.OMError:  # ozlint: allow[error-swallowing] -- already applied: state converges
                pass
            self.applied_index = e["index"]

    # ------------------------------------------------------------- serving
    def submit(self, request: rq.OMRequest) -> Any:
        """Leader write path: preExecute -> log -> replicate -> apply."""
        with self._lock:
            if not self.is_leader:
                raise NotLeaderError(self.om_id)
            request.pre_execute(self.om)
            entry = {
                "index": self.wal.index + 1,
                "request": request.to_json(),
            }
            self.wal.append(entry)
            for peer in self.peers:
                try:
                    peer.replicate(entry)
                except Exception:
                    log.exception("replication to %s failed", peer.om_id)
            result = request.apply(self.om.store)
            self.applied_index = entry["index"]
            return result

    def replicate(self, entry: dict) -> None:
        """Follower apply path (applyTransaction analog)."""
        with self._lock:
            if entry["index"] <= self.applied_index:
                return  # duplicate
            if entry["index"] != self.applied_index + 1:
                self.catch_up()
                if entry["index"] != self.applied_index + 1:
                    raise ValueError(
                        f"log gap: at {self.applied_index}, got "
                        f"{entry['index']}"
                    )
            self.wal.append(entry)
            try:
                rq.OMRequest.from_json(entry["request"]).apply(self.om.store)
            except rq.OMError as e:
                # deterministic failures also happen on the leader; keep
                # the index advancing
                log.debug("follower apply error: %s", e)
            self.applied_index = entry["index"]

    def catch_up(self) -> None:
        """Pull missing entries from the leader (follower bootstrap /
        InterSCMGrpcProtocolService-style checkpoint+delta catch-up)."""
        leader = next((p for p in self.peers if p.is_leader), None)
        if leader is None:
            return
        for e in leader.wal.read_from(self.applied_index):
            if e["index"] > self.applied_index:
                self.wal.append(e)
                try:
                    rq.OMRequest.from_json(e["request"]).apply(self.om.store)
                except rq.OMError:  # ozlint: allow[error-swallowing] -- already applied: state converges
                    pass
                self.applied_index = e["index"]

    # ------------------------------------------------------------- failover
    def promote(self) -> None:
        """Make this replica the leader (after catching up)."""
        self.catch_up()
        for p in self.peers:
            p.is_leader = False
        self.is_leader = True
        log.info("om %s promoted to leader at index %d", self.om_id,
                 self.applied_index)


class NotLeaderError(Exception):
    pass


class RaftOzoneManager:
    """OM replica on quorum consensus — the full OzoneManagerRatisServer
    analog (ozone-manager om/ratis/OzoneManagerRatisServer.java:108):
    leader elections with terms and randomized timeouts, replicated log
    with quorum commit, deterministic applyTransaction on every replica,
    and snapshot-based follower bootstrap (consensus/raft.py).

    Request lifecycle matches the reference exactly: `submit` runs
    preExecute on the leader (block allocation, normalization), proposes
    the serialized request through Raft, and returns the local apply
    result once the entry commits. Deterministic OMErrors replicate like
    any result so every replica's table state stays byte-identical.
    """

    def __init__(
        self,
        om: OzoneManager,
        raft_dir: Path,
        om_id: str,
        peer_ids: list[str],
        transport=None,
        config=None,
    ):
        from ozone_tpu_torch.consensus.raft import RaftConfig, RaftNode

        self.om = om
        self.om_id = om_id
        self.node = RaftNode(
            om_id,
            peer_ids,
            Path(raft_dir),
            apply_fn=self._apply,
            snapshot_fn=om.store.export_state,
            restore_fn=om.store.import_state,
            config=config or RaftConfig(),
            transport=transport,
        )

    def _apply(self, data: dict) -> Any:
        return rq.OMRequest.from_json(data).apply(self.om.store)

    @property
    def is_leader(self) -> bool:
        return self.node.is_leader

    def submit(self, request: rq.OMRequest) -> Any:
        if not self.node.is_leader:
            raise NotLeaderError(self.om_id)
        request.pre_execute(self.om)
        result = self.node.propose(request.to_json())
        if isinstance(result, Exception):
            raise result
        return result

    def start(self) -> None:
        self.node.start_timers()

    def stop(self) -> None:
        self.node.stop()


class OMFailoverProxy:
    """Client-side failover across OM replicas (OMFailoverProxyProvider
    analog): tries the known leader first, rotates on NotLeaderError or
    connection failure."""

    def __init__(self, replicas: list):
        self.replicas = replicas
        self._leader_idx = 0

    def submit(self, request: rq.OMRequest) -> Any:
        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        last: Optional[Exception] = None
        n = len(self.replicas)
        for attempt in range(n):
            idx = (self._leader_idx + attempt) % n
            try:
                result = self.replicas[idx].submit(request)
                self._leader_idx = idx
                return result
            except (NotLeaderError, NotRaftLeaderError, ConnectionError,
                    OSError) as e:
                last = e
        raise RuntimeError(f"no OM leader reachable: {last}")
