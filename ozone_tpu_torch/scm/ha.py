"""SCM high availability: the replicated mutation log and snapshot
bootstrap.

Port of `ozone_tpu/scm/ha.py` (the reference's SCM-HA stack:
SCMHAManagerImpl with a Ratis server whose SCMStateMachine applies
@Replicate decisions on every peer; SCMSnapshotProvider bootstraps new
followers from a checkpoint, then they tail the log). As in the
reference, the leader replicates *decisions*, not computations: the unit
is the durable mutation record the container manager emits on every
state change (the container row and the id counters), so apply is
deterministic though placement is random. Soft state (node liveness,
replica maps) is not replicated: every SCM hears every datanode's
heartbeats. `RaftSCM` runs on the Raft core with commit-first id
issuance (`scm/sequence_id.py`); `ReplicatedSCM` is promote()-based
single-leader replication over the OM's request log.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Any, Optional

from ozone_tpu_torch.om.ha import NotLeaderError, RequestLog
from ozone_tpu_torch.scm.scm import StorageContainerManager

log = logging.getLogger(__name__)


class ReplicatedSCM:
    """One SCM replica: the leader accepts mutating calls and ships each
    resulting durable mutation to followers; followers apply them onto
    their own managers (SCMStateMachine.applyTransaction analog)."""

    def __init__(
        self,
        scm: StorageContainerManager,
        log_path: Path,
        scm_id: str,
        is_leader: bool = False,
    ):
        self.scm = scm
        self.scm_id = scm_id
        self.is_leader = is_leader
        self.wal = RequestLog(log_path)
        self.applied_index = 0
        self.peers: list["ReplicatedSCM"] = []
        self._replaying = False
        scm.containers.mutation_listener = self._on_mutation
        self._recover()

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:
        self._replaying = True
        try:
            for e in self.wal.read_from(0):
                if "snapshot" in e:
                    # bootstrap checkpoint recorded in the WAL so restarts
                    # of a bootstrapped follower recover the full state
                    self.scm.containers.install_snapshot(e["snapshot"])
                else:
                    self.scm.containers.apply_mutation(
                        e["row"], tuple(e["counters"])
                    )
                self.applied_index = e["index"]
        finally:
            self._replaying = False

    # ------------------------------------------------------------- leader
    def _on_mutation(self, row: dict, counters: tuple[int, int]) -> None:
        """ContainerManager hook: on the leader, every durable mutation is
        appended to the WAL and pushed to followers synchronously (the
        reference's Ratis write happens *before* apply; we hook after —
        equivalent durability because the record is also in the local
        sqlite store, and replay converges via upsert)."""
        if self._replaying or not self.is_leader:
            return
        entry = {
            # applied_index, not WAL line count: a bootstrapped follower's
            # WAL holds one snapshot entry standing in for many indexes
            "index": self.applied_index + 1,
            "row": row,
            "counters": list(counters),
        }
        self.wal.append(entry)
        self.applied_index = entry["index"]
        for peer in self.peers:
            try:
                peer.replicate(entry)
            except Exception:
                log.exception("scm replication to %s failed", peer.scm_id)

    def check_leader(self) -> None:
        if not self.is_leader:
            raise NotLeaderError(self.scm_id)

    def submit(self, method: str, *args: Any, **kw: Any) -> Any:
        """Leader-gated mutating entry point (SCMHAInvocationHandler
        analog): clients/om route allocate_block, delete_blocks,
        decommission, ... through here so followers reject writes."""
        self.check_leader()
        return getattr(self.scm, method)(*args, **kw)

    # ------------------------------------------------------------- follower
    def replicate(self, entry: dict) -> None:
        if entry["index"] <= self.applied_index:
            return
        if entry["index"] != self.applied_index + 1:
            self.catch_up()
            if entry["index"] <= self.applied_index:
                return
            if entry["index"] != self.applied_index + 1:
                # gap we could not close (leader unreachable): stay behind
                # rather than skip entries; the next catch_up re-fetches
                log.warning(
                    "scm %s dropping out-of-order entry %d (applied %d)",
                    self.scm_id, entry["index"], self.applied_index,
                )
                return
        self._replaying = True
        try:
            self.wal.append(entry)
            self.scm.containers.apply_mutation(
                entry["row"], tuple(entry["counters"])
            )
            self.applied_index = entry["index"]
        finally:
            self._replaying = False

    def catch_up(self) -> None:
        leader = next((p for p in self.peers if p.is_leader), None)
        if leader is None:
            return
        self._replaying = True
        try:
            # scan from 0 and filter by index: WAL line offsets are not
            # indexes once a snapshot entry (standing in for many indexes)
            # is present in the leader's log
            for e in leader.wal.read_from(0):
                if e["index"] <= self.applied_index:
                    continue
                self.wal.append(e)
                if "snapshot" in e:
                    self.scm.containers.install_snapshot(e["snapshot"])
                else:
                    self.scm.containers.apply_mutation(
                        e["row"], tuple(e["counters"])
                    )
                self.applied_index = e["index"]
        finally:
            self._replaying = False

    # ------------------------------------------------------------- bootstrap
    def bootstrap_from(self, leader: "ReplicatedSCM") -> None:
        """New-follower bootstrap: install the leader's checkpoint, then
        tail its log (SCMSnapshotProvider + InterSCMGrpcProtocolService)."""
        snap = leader.scm.containers.snapshot_state()
        self._replaying = True
        try:
            self.scm.containers.install_snapshot(snap)
        finally:
            self._replaying = False
        self.applied_index = leader.applied_index
        # record the checkpoint durably so restart recovery and post-
        # promotion index assignment both see the bootstrapped state
        self.wal.append({"index": self.applied_index, "snapshot": snap})
        if self not in leader.peers:
            leader.peers.append(self)
        if leader not in self.peers:
            self.peers.append(leader)

    # ------------------------------------------------------------- failover
    def promote(self) -> None:
        self.catch_up()
        for p in self.peers:
            p.is_leader = False
        self.is_leader = True
        log.info(
            "scm %s promoted to leader at index %d",
            self.scm_id,
            self.applied_index,
        )


class RaftSCM:
    """SCM replica on quorum consensus — the full SCMRatisServerImpl +
    SCMStateMachine analog (server-scm ha/): elections, quorum-committed
    mutation log, snapshot bootstrap for lagging followers.

    Replication unit matches the reference's design (and ReplicatedSCM
    above): the leader replicates *decision records* — durable container
    mutations + HA-safe id counters — not the computations that produced
    them, so apply is deterministic despite randomized placement. Soft
    state (node liveness, replica maps) is rebuilt from heartbeats on
    every SCM, exactly like the reference.

    Concurrency contract (lock order is raft-node -> container-manager,
    never the reverse):
    - The ContainerManager mutation hook runs under the container lock;
      it only *enqueues* the decision record. A single dispatcher thread
      proposes records through raft in mutation order, so client threads
      never touch raft state while holding the container lock.
    - Records the leader enqueued are already applied to its own state
      (the mutation produced them), so the local commit apply skips them
      by record id; followers (and log replay after a restart, when the
      in-flight set is empty) apply every record.
    - submit() acks the client only after the records its call produced
      are quorum-committed — the same client-visible durability as the
      reference, where the Ratis write precedes the response.
    - If leadership is lost with enqueued-but-uncommitted records, this
      replica's state has effects the quorum never accepted; it resyncs
      by fetching the new leader's full committed state (fetch_state)
      before serving again.
    """

    def __init__(
        self,
        scm: StorageContainerManager,
        raft_dir: Path,
        scm_id: str,
        peer_ids: list[str],
        transport=None,
        config=None,
        ack_timeout_s: float = 30.0,
    ):
        import queue as _queue

        from ozone_tpu_torch.consensus.raft import RaftConfig, RaftNode

        self.scm = scm
        self.scm_id = scm_id
        self.ack_timeout_s = ack_timeout_s
        self._queue: "_queue.Queue" = _queue.Queue()  # ozlint: allow[bounded-queue] -- bounded by the ack window
        self._inflight: set[str] = set()
        self._seq = 0
        self._committed_seq = 0
        self._ack_cv = threading.Condition()
        self._needs_resync = False
        self._stop = threading.Event()
        self.node = RaftNode(
            scm_id,
            peer_ids,
            Path(raft_dir),
            apply_fn=self._apply,
            snapshot_fn=scm.containers.snapshot_state,
            restore_fn=self._restore,
            config=config or RaftConfig(),
            transport=transport,
            on_step_down=self._on_step_down,
        )
        scm.containers.mutation_listener = self._on_mutation
        # commit-first id issuance (SequenceIdGenerator.java:52-84): the
        # container manager draws container/block/pipeline ids only from
        # ranges this ring already committed; a hand-off invalidates the
        # local batch, so two terms can never issue the same id
        from ozone_tpu_torch.scm.sequence_id import SequenceIdGenerator

        self.ids = SequenceIdGenerator(self._reserve_ids)
        scm.containers.id_source = self.ids
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"scm-ha-dispatch-{scm_id}")
        self._dispatcher.start()

    def _reserve_ids(self, kind: str, count: int) -> tuple[int, int]:
        """Propose an absolute range reservation and wait for the quorum
        commit; the applied result is the reserved [lo, hi). The
        is_ready_leader gate matters: a just-elected leader that has not
        applied the committed prefix could read a stale floor and compose
        a range overlapping one already exposed — readiness (plus the
        deterministic apply-side rejection) closes that window. Raises
        NotRaftLeaderError when this node cannot commit — the caller's
        allocation fails WITHOUT exposing any id, and the client retries
        on the real leader."""
        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        for _ in range(8):
            if not self.node.is_ready_leader:
                raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
            lo = self.scm.containers.peek_id_floor(kind)
            result = self.node.propose(
                {"seq_reserve": {"kind": kind, "lo": lo,
                                 "hi": lo + int(count)}},
                timeout=self.ack_timeout_s,
            )
            if isinstance(result, Exception):
                raise result
            if result is not None:
                lo, hi = result
                return int(lo), int(hi)
            # stale floor (an earlier in-log reservation intervened):
            # re-read and retry
        raise TimeoutError(
            f"id reservation for {kind!r} kept racing the floor")

    # ------------------------------------------------------------- leader
    def _on_mutation(self, row: dict, counters: tuple[int, int]) -> None:
        """ContainerManager hook (runs under the container lock): enqueue
        the decision record. Enqueue order == mutation order because the
        hook fires inside the mutating critical section."""
        if not self.node.is_leader:
            return
        with self._ack_cv:
            self._seq += 1
            rec_id = f"{self.scm_id}:{self._seq}"
            self._inflight.add(rec_id)
        self._queue.put(
            {"id": rec_id, "seq": self._seq, "row": row,
             "counters": list(counters)}
        )

    def _dispatch_loop(self) -> None:
        import queue as _queue

        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        while not self._stop.is_set():
            try:
                rec = self._queue.get(timeout=0.1)
            except _queue.Empty:
                self._maybe_resync()
                continue
            while not self._stop.is_set():
                try:
                    self.node.propose(
                        {k: rec[k] for k in ("id", "row", "counters")},
                        timeout=5.0,
                    )
                    with self._ack_cv:
                        self._committed_seq = rec["seq"]
                        self._ack_cv.notify_all()
                    break
                except NotRaftLeaderError:
                    # effects of this record exist locally but were never
                    # accepted by the quorum: flag for state resync and
                    # fail any waiting submits
                    with self._ack_cv:
                        self._needs_resync = True
                        self._committed_seq = rec["seq"]
                        self._ack_cv.notify_all()
                    break
                except TimeoutError:  # ozlint: allow[error-swallowing] -- retry while still leader
                    continue

    def _maybe_resync(self) -> None:
        import queue as _queue

        if not self._needs_resync or self.node.is_leader:
            return
        hint = self.node.leader_hint
        if not hint or hint == self.scm_id:
            return
        # drop queued records that will never replicate (their effects are
        # about to be overwritten by the leader's committed state)
        try:
            while True:
                rec = self._queue.get_nowait()
                with self._ack_cv:
                    self._committed_seq = max(self._committed_seq,
                                              rec["seq"])
                    self._ack_cv.notify_all()
        except _queue.Empty:  # ozlint: allow[error-swallowing] -- drained
            pass
        try:
            if self.node.fetch_state_from(hint):
                with self._ack_cv:
                    self._needs_resync = False
                    self._inflight.clear()
                # state replaced wholesale: any leftover local batch is
                # from a leadership the quorum moved past
                self.ids.invalidate()
                log.info("scm %s resynced from leader %s", self.scm_id, hint)
        except Exception as e:
            log.debug("scm %s resync attempt failed: %s", self.scm_id, e)

    def _on_step_down(self) -> None:
        """Raft callback (node lock held — flags only): unreplicated local
        effects mean divergence; resync from the new leader. The id
        batches die with the leadership (invalidateBatch analog) — their
        unissued tails are burned, never re-reserved."""
        self.ids.invalidate()
        with self._ack_cv:
            if self._inflight or not self._queue.empty():
                self._needs_resync = True
            self._ack_cv.notify_all()

    # ------------------------------------------------------------- apply
    def _apply(self, data: dict):
        if "seq_reserve" in data:
            r = data["seq_reserve"]
            return self.scm.containers.reserve_id_range(
                r["kind"], int(r["lo"]), int(r["hi"]))
        rec_id = data.get("id")
        if rec_id is not None:
            with self._ack_cv:
                if rec_id in self._inflight:
                    # our own record: the mutation that produced it
                    # already updated local state
                    self._inflight.discard(rec_id)
                    return
        self.scm.containers.apply_mutation(
            data["row"], tuple(data["counters"])
        )

    def _restore(self, snap: dict) -> None:
        self.scm.containers.install_snapshot(snap)

    @property
    def is_leader(self) -> bool:
        return self.node.is_leader

    # ------------------------------------------------------------- serving
    def submit(self, method: str, *args: Any, **kw: Any) -> Any:
        """Leader-gated mutating call; returns after every decision record
        the call produced is quorum-committed."""
        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        if not self.node.is_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        result = getattr(self.scm, method)(*args, **kw)
        self._await_records()
        return result

    def _await_records(self) -> None:
        """Block until every decision record enqueued so far is
        quorum-committed (the ack tail shared with the combined
        metadata ring's OM submits)."""
        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        deadline = time.monotonic() + self.ack_timeout_s
        with self._ack_cv:
            target = self._seq
            while self._committed_seq < target:
                if self._needs_resync or not self.node.is_leader:
                    raise NotRaftLeaderError(self.scm_id,
                                             self.node.leader_hint)
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        "scm mutation not committed within "
                        f"{self.ack_timeout_s}s")
                self._ack_cv.wait(timeout=min(left, 0.05))

    def start(self) -> None:
        self.node.start_timers()

    def stop(self) -> None:
        self._stop.set()
        self.node.stop()
        self._dispatcher.join(timeout=1.0)


class SCMFailoverProxy:
    """Client/OM-side failover across SCM replicas (the reference's
    SCMBlockLocationFailoverProxyProvider): tries the known leader,
    rotates on NotLeaderError or connection failure."""

    def __init__(self, replicas: list[ReplicatedSCM]):
        self.replicas = replicas
        self._leader_idx = 0

    def submit(self, method: str, *args: Any, **kw: Any) -> Any:
        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        last: Optional[Exception] = None
        n = len(self.replicas)
        for attempt in range(n):
            idx = (self._leader_idx + attempt) % n
            try:
                result = self.replicas[idx].submit(method, *args, **kw)
                self._leader_idx = idx
                return result
            except (NotLeaderError, NotRaftLeaderError, TimeoutError,
                    ConnectionError, OSError) as e:
                last = e
        raise RuntimeError(f"no SCM leader reachable: {last}")
