"""A compact Raft core: elections, quorum commit, log repair, snapshots
and single-server membership change.

Port of `ozone_tpu/consensus/raft.py` (the role Apache Ratis plays in the
reference: OM HA through OzoneManagerRatisServer.submitRequest, SCM HA
through SCMRatisServerImpl and SCMStateMachine, datanode pipelines
through XceiverServerRatis). The state machine contract is the
reference's: an opaque `apply(data) -> result` callback invoked exactly
once per committed entry, in log order, on every replica.

- Leader election with randomized timeouts, a pre-vote round, term and
  vote durability, the log-up-to-date vote check and step-down on higher
  terms (Raft sections 5.1-5.2, 9.6).
- AppendEntries consistency check, conflict truncation and next_index
  backtracking (5.3); commit of current-term entries only by counting
  replicas (5.4.2).
- Snapshot install for follower bootstrap; log compaction behind a
  snapshot.
- Single-server membership change (4.1): a config entry takes effect
  when appended, one change at a time; leadership transfer (3.10).

`RaftStorage` keeps the reference's on-disk format byte for byte
(`meta.json`, `log.jsonl` with its `_logstart` header, `snapshot.json`
with its `_snapmeta` stamp), so a directory written by either package
loads in the other. Every append is fsync'd. The `commit_seconds`
histogram of `propose` lives on the port's `utils/metrics` registry of
the node. Transports are pluggable: `InProcessTransport` wires nodes
directly for tests (with partitions and downed nodes), and
`net/raft_transport.RpcRaftTransport` carries the same dicts over the
port's RPC. Timers are optional so tests can drive elections by hand.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class NotRaftLeaderError(Exception):
    """Raised on writes addressed to a non-leader; carries the leader hint
    (the reference's OMNotLeaderException / SCMRatisResponse NotLeader)."""

    def __init__(self, node_id: str, leader_hint: Optional[str] = None):
        super().__init__(f"{node_id} is not the raft leader "
                         f"(leader hint: {leader_hint})")
        self.node_id = node_id
        self.leader_hint = leader_hint


@dataclass(frozen=True)
class RaftConfig:
    election_timeout_s: tuple[float, float] = (0.15, 0.3)
    heartbeat_interval_s: float = 0.05
    #: entries retained behind the snapshot when compacting
    snapshot_trailing: int = 64


class RaftStorage:
    """Durable term/vote + log (JSONL, fsync'd) with truncation.

    Equivalent of Ratis' RaftStorage/RaftLog segments; one directory per
    node holding `meta.json` (currentTerm, votedFor, snapshot marker) and
    `log.jsonl` (entries {term, data} from snapshot_index+1 up).
    """

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.meta_path = self.root / "meta.json"
        self.log_path = self.root / "log.jsonl"
        self.snap_path = self.root / "snapshot.json"
        self.term = 0
        self.voted_for: Optional[str] = None
        # log[i] corresponds to raft index snapshot_index + 1 + i
        self.entries: list[dict] = []
        self.snapshot_index = 0
        self.snapshot_term = 0
        self.snapshot_data: Any = None
        # membership-change history: [[index, {id: address}], ...] in
        # index order; the LAST entry is the active configuration. Empty
        # = legacy fixed membership (the constructor peer list governs).
        # Persisted with term/vote: a node must never forget a config it
        # acted on (Raft §4.1 — configs take effect when APPENDED).
        self.config_history: list[list] = []
        # long-lived append handle: the hot path fsyncs every entry and
        # must not also pay an open() per append; dropped whenever the
        # log file is rewritten wholesale (truncate/compact/snapshot)
        self._append_f = None
        self._load()

    def _load(self) -> None:
        if self.meta_path.exists():
            m = json.loads(self.meta_path.read_text())
            self.term = m.get("term", 0)
            self.voted_for = m.get("voted_for")
            self.snapshot_index = m.get("snapshot_index", 0)
            self.snapshot_term = m.get("snapshot_term", 0)
            self.config_history = m.get("config_history", [])
        if self.snap_path.exists():
            raw = json.loads(self.snap_path.read_text())
            if isinstance(raw, dict) and "_snapmeta" in raw:
                # self-describing snapshot (crash recovery: the data
                # file is written BEFORE the meta marker, so after a
                # crash mid-compaction the file's own stamp wins)
                self.snapshot_data = raw["data"]
                sm = raw["_snapmeta"]
                if sm["index"] > self.snapshot_index:
                    self.snapshot_index = sm["index"]
                    self.snapshot_term = sm["term"]
            else:  # legacy bare payload
                self.snapshot_data = raw
        log_start = None
        if self.log_path.exists():
            with open(self.log_path) as f:
                rows = [json.loads(ln) for ln in f if ln.strip()]
            if rows and "_logstart" in rows[0]:
                log_start = rows[0]["_logstart"]
                rows = rows[1:]
            self.entries = rows
        # entries are POSITIONAL after the snapshot point; the header
        # records which point the file was written against. A crash
        # between the snapshot write and the log rewrite leaves a log
        # that starts below the (now-authoritative) snapshot index —
        # drop the prefix the snapshot already covers.
        if log_start is None:
            log_start = self.snapshot_index  # legacy / fresh file
        if log_start < self.snapshot_index:
            self.entries = self.entries[self.snapshot_index - log_start:]
        # crash repair: a config entry is fsync'd to the log BEFORE its
        # meta record (append -> record_config); a crash in that window
        # must not silently revert membership — replay any _config
        # entries the log holds past the newest recorded config
        last_cfg = self.config_history[-1][0] if self.config_history else 0
        repaired = False
        for off, e in enumerate(self.entries):
            idx = self.snapshot_index + off + 1
            d = e.get("data")
            if idx > last_cfg and isinstance(d, dict) and "_config" in d:
                self.config_history.append(
                    [idx, dict(d["_config"]["members"])])
                repaired = True
        if repaired:
            self.persist_meta()

    @staticmethod
    def _write_durable(path: Path, payload: str) -> None:
        tmp = path.with_suffix(".tmp")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, payload.encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)

    def persist_meta(self) -> None:
        """Durably record term/vote (+ snapshot marker). fsync'd: a
        forgotten vote after a crash would allow double-voting and two
        leaders in one term (Raft §5.2 election safety). The snapshot
        payload itself lives in its own file written only at snapshot
        time — votes/term bumps must not rewrite the whole app state."""
        self._write_durable(self.meta_path, json.dumps({
            "term": self.term,
            "voted_for": self.voted_for,
            "snapshot_index": self.snapshot_index,
            "snapshot_term": self.snapshot_term,
            "config_history": self.config_history,
        }))

    @property
    def members(self) -> Optional[dict]:
        """Active configuration ({id: address}) or None (legacy fixed)."""
        return self.config_history[-1][1] if self.config_history else None

    def config_at(self, index: int) -> Optional[dict]:
        """The configuration in force AT raft index `index` (newest
        config entry stamped at or below it), or None. A snapshot must
        ship THIS — not the live config: an uncommitted config entry
        above the snapshot point still rides the log and must stay
        truncatable on the receiver."""
        base = None
        for i, m in self.config_history:
            if i <= index:
                base = m
        return base

    def record_config(self, index: int, members: dict) -> None:
        self.config_history.append([index, dict(members)])
        self.persist_meta()

    def truncate_configs_from(self, index: int) -> None:
        """Drop config entries at raft index >= index (log conflict
        repair must also revert the configurations those entries
        carried)."""
        before = len(self.config_history)
        self.config_history = [c for c in self.config_history
                               if c[0] < index]
        if len(self.config_history) != before:
            self.persist_meta()

    def compact_configs(self, upto_index: int,
                        persist: bool = True) -> None:
        """Keep only the active config at/below the snapshot point.
        `persist=False` when the caller sequences its own persist_meta
        LAST (compact: persisting meta with the new snapshot_index
        before the log/snapshot files hit disk would misindex the whole
        log if we crash in between)."""
        live = [c for c in self.config_history if c[0] > upto_index]
        base = [c for c in self.config_history if c[0] <= upto_index]
        if base:
            self.config_history = [base[-1]] + live
            if persist:
                self.persist_meta()

    def persist_snapshot(self) -> None:
        # self-describing: carries its own index/term so recovery never
        # has to trust a meta marker that may not have been written yet
        self._write_durable(
            self.snap_path, json.dumps({
                "_snapmeta": {"index": self.snapshot_index,
                              "term": self.snapshot_term},
                "data": self.snapshot_data,
            }))

    def _log_payload(self) -> str:
        lines = [json.dumps({"_logstart": self.snapshot_index})]
        lines += [json.dumps(e, separators=(",", ":"))
                  for e in self.entries]
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------- log ops
    @property
    def last_index(self) -> int:
        return self.snapshot_index + len(self.entries)

    def term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snapshot_index:
            return self.snapshot_term
        i = index - self.snapshot_index - 1
        if 0 <= i < len(self.entries):
            return self.entries[i]["term"]
        return None

    def entry_at(self, index: int) -> Optional[dict]:
        i = index - self.snapshot_index - 1
        if 0 <= i < len(self.entries):
            return self.entries[i]
        return None

    def append(self, entries: list[dict]) -> None:
        f = self._append_f
        if f is None:
            fresh = (not self.log_path.exists()
                     or self.log_path.stat().st_size == 0)
            f = self._append_f = open(self.log_path, "a")
            if fresh:  # stamp which point the positions count from
                f.write(json.dumps({"_logstart": self.snapshot_index})
                        + "\n")
        for e in entries:
            f.write(json.dumps(e, separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())
        self.entries.extend(entries)

    def _drop_append_handle(self) -> None:
        if self._append_f is not None:
            self._append_f.close()
            self._append_f = None

    def close(self) -> None:
        self._drop_append_handle()

    def truncate_from(self, index: int) -> None:
        """Drop entries at raft index >= index (conflict repair)."""
        keep = max(0, index - self.snapshot_index - 1)
        if keep >= len(self.entries):
            return
        self.truncate_configs_from(index)
        self.entries = self.entries[:keep]
        self._drop_append_handle()
        self._write_durable(self.log_path, self._log_payload())

    def install_snapshot(self, index: int, term: int, data: Any,
                         members: Optional[dict] = None) -> None:
        self.snapshot_index = index
        self.snapshot_term = term
        self.snapshot_data = data
        self.entries = []
        if members is not None:
            # the shipped snapshot's configuration supersedes anything
            # this (wiped) log knew
            self.config_history = [[index, dict(members)]]
        else:
            # the log was wiped: configs carried by entries above the
            # snapshot point no longer have a backing log entry
            self.config_history = [c for c in self.config_history
                                   if c[0] <= index]
        # crash-safe order: self-stamped snapshot first, then drop the
        # log, meta last (a stale log next to a newer snapshot is
        # reconciled by _load; a stale snapshot next to a newer meta
        # marker is not recoverable)
        self.persist_snapshot()
        self._drop_append_handle()
        if self.log_path.exists():
            self.log_path.unlink()
        self.persist_meta()

    def compact(self, upto_index: int, term: int, data: Any,
                trailing: int) -> None:
        """Compact the log to exactly `upto_index` — the snapshot DATA
        is the state at that index, so the marker must match it: a
        shipped snapshot whose index trailed its data would make the
        receiving follower replay entries whose effects the snapshot
        already contains (double-apply). `trailing` is a frequency
        guard: don't bother compacting until at least that many entries
        sit behind the apply point."""
        if upto_index - self.snapshot_index <= trailing:
            return
        cut = upto_index
        if cut <= self.snapshot_index:
            return
        drop = cut - self.snapshot_index
        self.entries = self.entries[drop:]
        self.snapshot_index = cut
        self.snapshot_term = term
        self.compact_configs(cut, persist=False)
        self.snapshot_data = data
        # crash-safe order: snapshot data (self-stamped) first, then the
        # log (headered with its start point), meta marker LAST. A crash
        # at any boundary reloads consistently: the snapshot's own stamp
        # overrides a stale meta, and _load drops log entries the
        # snapshot already covers.
        self.persist_snapshot()
        self._drop_append_handle()
        self._write_durable(self.log_path, self._log_payload())
        self.persist_meta()


class RaftNode:
    """One consensus peer.

    apply_fn(data) is invoked once per committed entry in order; its return
    value resolves the originating propose() when this node is the leader.
    snapshot_fn()/restore_fn(data) (optional) capture and install the full
    application state for follower bootstrap and log compaction.
    """

    def __init__(
        self,
        node_id: str,
        peer_ids: list[str],
        storage_dir: Path,
        apply_fn: Callable[[Any], Any],
        snapshot_fn: Optional[Callable[[], Any]] = None,
        restore_fn: Optional[Callable[[Any], None]] = None,
        config: RaftConfig = RaftConfig(),
        transport: Optional["Transport"] = None,
        on_step_down: Optional[Callable[[], None]] = None,
        metrics_name: Optional[str] = None,
    ):
        self.node_id = node_id
        self.peer_ids = [p for p in peer_ids if p != node_id]
        self.storage = RaftStorage(Path(storage_dir))
        # membership (Raft §4: single-server changes carried as log
        # entries, effective when APPENDED). A persisted configuration
        # overrides the constructor peer list; without one the ring is
        # fixed at construction (legacy behavior).
        #: the construction-time ring — the fallback configuration when
        #: a truncation erases every persisted config entry
        self._initial_members = {p: "" for p in [node_id, *self.peer_ids]}
        self.members: dict[str, str] = (
            dict(self.storage.members)
            if self.storage.members is not None
            else dict(self._initial_members)
        )
        #: serializes change_membership end-to-end (check + propose);
        #: ordered strictly before the node lock
        self._membership_lock = threading.Lock()
        if self.storage.members is not None:
            self.peer_ids = [p for p in self.members if p != node_id]
        #: optional hook fired on config adoption with {id: address} —
        #: daemons refresh their peer address books through it (property:
        #: registering it replays the persisted membership, so a restarted
        #: node's address book reflects replicas added after its original
        #: start)
        self._on_config: Optional[Callable[[dict], None]] = None
        #: raft index of the newest config entry in the log (0 = none);
        #: a new change is refused until the previous one commits
        self._config_index = (self.storage.config_history[-1][0]
                              if self.storage.config_history else 0)
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.config = config
        self.transport = transport or InProcessTransport()
        self.transport.register(self)
        # replay persisted membership addresses into the transport: a
        # restarted node whose CLI peer list predates an online ring
        # growth must still be able to reach the replicas the persisted
        # config admitted, or as leader it would silently strand them
        if self.storage.members is not None:
            for p, addr in self.members.items():
                if p != node_id and addr and hasattr(self.transport,
                                                    "set_peer"):
                    self.transport.set_peer(p, addr)

        self.role = FOLLOWER
        self.leader_hint: Optional[str] = None
        self.commit_index = self.storage.snapshot_index
        self.last_applied = self.storage.snapshot_index
        # per-group metrics (Ratis server metrics analog: role/term/
        # indices + election and apply counters), exported through the
        # daemon's /prom. A node serving several raft groups (one per
        # pipeline) must pass a distinct metrics_name per group or the
        # groups would clobber each other's gauges.
        from ozone_tpu_torch.utils.metrics import registry

        self.metrics = registry(metrics_name or f"raft.{node_id}")
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        #: leader-side view of each follower's apply watermark (reported
        #: in append_entries responses) — feeds watchForCommit(ALL)
        self.applied_index: dict[str, int] = {}
        # results are retained only for indexes with a registered waiter
        # (a blocked propose()) — otherwise apply results would accumulate
        # unboundedly over a long leadership
        self._waiters: set[int] = set()
        self._results: dict[int, Any] = {}
        self.on_step_down = on_step_down
        #: follower read-lease renewal hook (om/sharding/leases.py wires
        #: a metrics counter): called on every accepted append_entries,
        #: under the node lock — must only bump counters, never call
        #: back into this node
        self.on_lease_renewal: Optional[Callable[[], None]] = None
        #: leadership hand-off in flight (§3.10): propose() refuses
        self._transferring = False
        #: index of this term's no-op marker (set on winning an election)
        self._leader_ready_index = 0

        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        # -inf: a node that has never heard a leader must not refuse
        # pre-votes on "live leader contact" grounds
        self._last_heartbeat = float("-inf")
        self._timer_thread: Optional[threading.Thread] = None

        # restore application state from the durable snapshot, then replay
        # the committed suffix on the next leader contact / election
        if self.storage.snapshot_data is not None and self.restore_fn:
            self.restore_fn(self.storage.snapshot_data)

    # ----------------------------------------------------------- lifecycle
    def start_timers(self) -> None:
        """Enable background election/heartbeat timers (daemon mode).

        Tests usually drive `tick()`/`start_election()` directly instead,
        the way the reference unit-tests Ratis state machines without
        real clocks.
        """
        if self._timer_thread:
            return
        self._timer_thread = threading.Thread(
            target=self._timer_loop, daemon=True,
            name=f"raft-{self.node_id}")
        self._election_deadline = self._new_deadline()
        self._timer_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._timer_thread:
            self._timer_thread.join(timeout=1.0)
            self._timer_thread = None
        self.storage.close()

    def _new_deadline(self) -> float:
        lo, hi = self.config.election_timeout_s
        return time.monotonic() + random.uniform(lo, hi)

    def _timer_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.config.heartbeat_interval_s / 2)
            with self._lock:
                role = self.role
            if role == LEADER:
                self._broadcast_heartbeat()
            elif time.monotonic() >= self._election_deadline:
                self.start_election()
                # re-randomize AFTER the (possibly slow) round: a vote
                # RPC hanging on a dead peer would otherwise consume the
                # whole jitter window and keep rival candidates in
                # lockstep, splitting votes forever
                self._election_deadline = self._new_deadline()

    # ----------------------------------------------------------- membership
    def _quorum(self) -> int:
        return len(self.members) // 2 + 1

    @property
    def on_config(self) -> Optional[Callable[[dict], None]]:
        return self._on_config

    @on_config.setter
    def on_config(self, cb: Optional[Callable[[dict], None]]) -> None:
        self._on_config = cb
        # replay: the persisted ring may differ from what the daemon
        # derived from its (possibly stale) CLI peer list
        if cb is not None and self.storage.members is not None:
            self._notify_config()

    def _notify_config(self) -> None:
        if self._on_config is not None:
            try:
                self._on_config(dict(self.members))
            except Exception:
                log.exception("on_config callback failed")

    def _adopt_config(self, index: int, members: dict,
                      record: bool = True) -> None:
        """Switch to a configuration the moment its entry is appended
        (Raft §4.1). Called with the node lock held. `record=False`
        when the storage already persisted it (snapshot install)."""
        self.members = dict(members)
        self.peer_ids = [p for p in self.members if p != self.node_id]
        self._config_index = index
        if record:
            self.storage.record_config(index, members)
        for p in self.peer_ids:
            self.next_index.setdefault(p, self.storage.last_index + 1)
            self.match_index.setdefault(p, 0)
            addr = self.members.get(p)
            if addr and hasattr(self.transport, "set_peer"):
                self.transport.set_peer(p, addr)
        log.info("raft %s: adopted config @%d: %s", self.node_id, index,
                 sorted(self.members))
        self._notify_config()

    def _revert_config_after_truncate(self) -> None:
        """A log conflict truncated entries that may have carried
        configs; fall back to what the storage history now says — or to
        the construction-time ring when the truncation erased every
        persisted config (a phantom adopted config must not survive)."""
        members = self.storage.members
        if members is None:
            members = self._initial_members
        if members != self.members:
            self.members = dict(members)
            self.peer_ids = [p for p in self.members
                             if p != self.node_id]
            self._config_index = (self.storage.config_history[-1][0]
                                  if self.storage.config_history else 0)
            # the adopt path notified the daemon of the phantom config;
            # the revert must notify too, or ring_provider keeps
            # advertising a replica the ring never actually admitted
            self._notify_config()

    def change_membership(self, add: Optional[str] = None,
                          address: str = "",
                          remove: Optional[str] = None,
                          timeout: float = 10.0) -> dict:
        """Single-server membership change (leader only): add ONE node
        (with its transport address) or remove ONE node. Changes are
        serialized — a new change is refused while the previous config
        entry is uncommitted — which keeps majorities of consecutive
        configs overlapping without joint consensus (Raft §4.1; the
        reference drives the same through Ratis setConfiguration)."""
        with self._membership_lock:
            return self._change_membership_locked(add, address, remove,
                                                  timeout)

    def _change_membership_locked(self, add, address, remove,
                                  timeout) -> dict:
        with self._lock:
            if self.role != LEADER:
                raise NotRaftLeaderError(self.node_id, self.leader_hint)
            if self._config_index > self.commit_index:
                raise RuntimeError(
                    f"config change at index {self._config_index} still "
                    f"uncommitted; one change at a time")
            if (add is None) == (remove is None):
                raise ValueError("exactly one of add/remove required")
            if remove == self.node_id:
                raise ValueError(
                    "leader cannot remove itself; transfer leadership "
                    "first (stop this node and let the ring elect)")
            new = dict(self.members)
            if add is not None:
                new[add] = address
            else:
                if remove not in new:
                    raise ValueError(f"{remove!r} is not a member")
                del new[remove]
        # propose() appends the entry; _propose_locked adopts it at
        # append time, so replication to the NEW config starts at once
        result = self.propose({"_config": {"members": new}},
                              timeout=timeout)
        if isinstance(result, Exception):
            raise result
        if remove is not None:
            # best-effort: let the departing node learn the config that
            # removed it, so it stops campaigning (Raft §4.2.3; the
            # sticky-leader pre-vote covers the unreachable case)
            try:
                self._replicate_to(remove)
            except Exception:  # ozlint: allow[error-swallowing] -- best-effort courtesy send
                pass
        return dict(new)

    # ------------------------------------------------- leadership transfer
    def transfer_leadership(self, target: str,
                            timeout: float = 10.0) -> bool:
        """Planned hand-off (Raft §3.10, the reference's Ratis
        TransferLeadership behind `ozone admin om transfer`): catch the
        target up, then tell it to campaign immediately (timeout_now);
        its RequestVote carries leadership_transfer=True so voters skip
        the sticky-leader check that normally protects a live leader.
        Returns True once this node observes itself deposed."""
        deadline = time.monotonic() + timeout
        with self._lock:
            if self.role != LEADER:
                raise NotRaftLeaderError(self.node_id, self.leader_hint)
            if target == self.node_id:
                return True
            if target not in self.members:
                raise ValueError(f"{target!r} is not a ring member")
            if self._transferring:
                raise ValueError("a leadership transfer is already "
                                 "in flight")
            # §3.10: stop accepting client proposals for the duration —
            # new entries appended mid-hand-off would make the target's
            # log stale again and the sanctioned election lose
            self._transferring = True
        try:
            caught_up = False
            while time.monotonic() < deadline:
                try:
                    self._replicate_to(target)
                except Exception:  # ozlint: allow[error-swallowing] -- retried until the deadline
                    pass
                with self._lock:
                    if self.role != LEADER:
                        return True  # someone took over already
                    caught_up = (self.match_index.get(target, 0)
                                 >= self.storage.last_index)
                    term = self.storage.term
                if caught_up:
                    break
                time.sleep(0.05)
            if not caught_up:
                return False
            send_failed = False
            try:
                resp = self.transport.send(
                    target, "timeout_now",
                    {"term": term, "leader_id": self.node_id})
                if resp.get("ok") is False:
                    # the target ran its election synchronously and
                    # lost — no point burning the rest of the deadline
                    with self._lock:
                        return self.role != LEADER
            except Exception:
                # the RPC may have timed out AFTER delivery (the target
                # campaigns synchronously inside it) — watch for the
                # depose rather than declaring failure
                send_failed = True
            while time.monotonic() < deadline:
                with self._lock:
                    if self.role != LEADER:
                        return True  # deposed by the hand-off election
                time.sleep(0.02 if not send_failed else 0.1)
            return False
        finally:
            with self._lock:
                self._transferring = False

    def handle_timeout_now(self, req: dict) -> dict:
        """Target side of a leadership transfer: campaign NOW, skipping
        the pre-vote (the old leader sanctioned this election)."""
        with self._lock:
            if (req["term"] < self.storage.term
                    or self.node_id not in self.members):
                return {"term": self.storage.term, "ok": False}
        won = self.start_election(transfer=True)
        return {"term": self.storage.term, "ok": won}

    # ----------------------------------------------------------- elections
    def start_election(self, transfer: bool = False) -> bool:
        """Run one candidate round; returns True if this node won.

        A pre-vote phase (Raft §9.6) runs first: the would-be candidate
        probes electability at term+1 WITHOUT bumping its own term, so a
        rejoining replica with a stale log (or one behind a live leader)
        can never depose a healthy leader just by campaigning — the
        disruptive-server problem the reference delegates to Ratis'
        leader election with pre-vote."""
        with self._lock:
            if self.node_id not in self.members:
                return False  # removed from the ring: never campaign
            quorum = self._quorum()
        # randomized contact order + early exit: reachable peers decide
        # the election before any unreachable peer's RPC timeout is paid
        order = list(self.peer_ids)
        random.shuffle(order)
        if not transfer:
            # a transfer-sanctioned election skips the pre-vote: the
            # old leader vouched for this candidate, and the probe would
            # fail against peers still in live contact with that leader
            with self._lock:
                probe_term = self.storage.term + 1
                last_index = self.storage.last_index
                last_term = self.storage.term_at(last_index) or 0
            pre = 1
            for pid in order:
                if pre >= quorum:
                    break
                try:
                    resp = self.transport.send(pid, "request_vote", {
                        "term": probe_term,
                        "candidate_id": self.node_id,
                        "last_log_index": last_index,
                        "last_log_term": last_term,
                        "pre_vote": True,
                    })
                except Exception:  # ozlint: allow[error-swallowing] -- unreachable: the count decides
                    continue
                if resp.get("granted"):
                    pre += 1
            if pre < quorum:
                return False
        self.metrics.counter("elections_started").inc()
        with self._lock:
            self.role = CANDIDATE
            self.storage.term += 1
            self.storage.voted_for = self.node_id
            self.storage.persist_meta()
            term = self.storage.term
            last_index = self.storage.last_index
            last_term = self.storage.term_at(last_index) or 0
        votes = 1
        for pid in order:
            if votes >= quorum:
                break
            try:
                resp = self.transport.send(pid, "request_vote", {
                    "term": term,
                    "candidate_id": self.node_id,
                    "last_log_index": last_index,
                    "last_log_term": last_term,
                    "leadership_transfer": transfer,
                })
            except Exception:  # ozlint: allow[error-swallowing] -- unreachable: the count decides
                continue
            with self._lock:
                if resp["term"] > self.storage.term:
                    self._step_down(resp["term"])
                    return False
            if resp.get("granted"):
                votes += 1
        with self._lock:
            if self.role != CANDIDATE or self.storage.term != term:
                return False
            if votes >= quorum:
                self._become_leader()
                return True
            self.role = FOLLOWER
            return False

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_hint = self.node_id
        ni = self.storage.last_index + 1
        self.next_index = {p: ni for p in self.peer_ids}
        self.match_index = {p: 0 for p in self.peer_ids}
        log.info("raft %s: leader of term %d at index %d",
                 self.node_id, self.storage.term, self.storage.last_index)
        self.metrics.counter("elections_won").inc()
        self.metrics.gauge("is_leader").set(1)
        # replicate a no-op so the new leader can commit prior-term entries
        # (Raft §5.4.2 / Ratis leader-ready marker); until it applies,
        # this leader may not have applied everything already committed
        self._leader_ready_index = self._propose_locked({"_noop": True})

    def _step_down(self, term: int) -> None:
        was_leader = self.role == LEADER
        if term > self.storage.term:
            self.storage.term = term
            self.storage.voted_for = None
            self.storage.persist_meta()
        self.role = FOLLOWER
        self.metrics.gauge("is_leader").set(0)
        if was_leader:
            self.metrics.counter("step_downs").inc()
        if self.leader_hint == self.node_id:
            # a deposed leader must not keep advertising itself —
            # clients would pin to it and never find the real leader
            self.leader_hint = None
        if was_leader and self.on_step_down is not None:
            # called with the node lock held: the callback must only set
            # flags / enqueue work, never call back into this node
            try:
                self.on_step_down()
            except Exception:
                log.exception("on_step_down callback failed")

    # ----------------------------------------------------------- serving
    def propose(self, data: Any, timeout: float = 10.0) -> Any:
        """Leader write path: append -> replicate to quorum -> apply.

        The OzoneManagerRatisServer.submitRequest analog: blocks until the
        entry commits and the local state machine applied it, returning
        apply_fn's result, or raises NotRaftLeaderError.
        """
        with self._lock:
            if self.role != LEADER:
                raise NotRaftLeaderError(self.node_id, self.leader_hint)
            if self._transferring:
                # mid-hand-off (§3.10): refuse new entries; clients
                # retry and land on whichever leader the transfer yields
                raise NotRaftLeaderError(self.node_id, None)
            index = self._propose_locked(data, register_waiter=True)
        deadline = time.monotonic() + timeout
        from ozone_tpu_torch.utils.tracing import Tracer

        t_wait = time.monotonic()
        try:
            # the replicate-to-quorum-and-apply wait IS the consensus
            # cost a slow write pays: span + histogram so a retained
            # trace and the scrape agree on the commit stage
            with Tracer.instance().span("raft:commit_wait", index=index):
                with self._commit_cv:
                    while self.last_applied < index:
                        left = deadline - time.monotonic()
                        if left <= 0 or self._stop.is_set():
                            raise TimeoutError(
                                f"entry {index} not committed within "
                                f"{timeout}s")
                        if self.role != LEADER:
                            raise NotRaftLeaderError(self.node_id,
                                                     self.leader_hint)
                        self._commit_cv.wait(timeout=min(left, 0.05))
                        # single-threaded test mode: no timer thread to
                        # push replication, so drive it from here
                        if self.last_applied < index \
                                and self._timer_thread is None:
                            self._commit_cv.release()
                            try:
                                self._broadcast_heartbeat()
                            finally:
                                self._commit_cv.acquire()
                    result = self._results.pop(index, None)
            self.metrics.histogram("commit_seconds").observe(
                time.monotonic() - t_wait)
            return result
        finally:
            with self._lock:
                self._waiters.discard(index)
                self._results.pop(index, None)

    def _propose_locked(self, data: Any, register_waiter: bool = False) -> int:
        entry = {"term": self.storage.term, "data": data}
        self.storage.append([entry])
        index = self.storage.last_index
        if isinstance(data, dict) and "_config" in data:
            self._adopt_config(index, data["_config"]["members"])
        if register_waiter:
            self._waiters.add(index)
        self.match_index[self.node_id] = index
        # fast path: push to peers immediately (heartbeat retries failures)
        self._lock.release()
        try:
            self._broadcast_heartbeat()
        finally:
            self._lock.acquire()
        return index

    # ----------------------------------------------------------- replication
    def _broadcast_heartbeat(self) -> None:
        for pid in list(self.peer_ids):
            try:
                self._replicate_to(pid)
            except Exception as e:  # peer down: retried next heartbeat
                log.debug("raft %s -> %s replication failed: %s",
                          self.node_id, pid, e)
        self._advance_commit()

    def _replicate_to(self, pid: str) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            term = self.storage.term
            ni = self.next_index.get(pid, self.storage.last_index + 1)
            if ni <= self.storage.snapshot_index:
                # peer is behind the compaction horizon: ship the snapshot
                snap = {
                    "term": term,
                    "leader_id": self.node_id,
                    "last_included_index": self.storage.snapshot_index,
                    "last_included_term": self.storage.snapshot_term,
                    "data": self.storage.snapshot_data,
                    # configuration travels with the snapshot — the one
                    # in force AT the snapshot point, NOT the live one:
                    # a config entry above snapshot_index reaches the
                    # follower as a log entry and must stay truncatable
                    # (shipping self.members could burn an uncommitted
                    # ring change into the receiver's base config)
                    "members": self.storage.config_at(
                        self.storage.snapshot_index),
                }
                resp = None
                self._lock.release()
                try:
                    resp = self.transport.send(pid, "install_snapshot", snap)
                finally:
                    self._lock.acquire()
                if resp and resp["term"] > self.storage.term:
                    self._step_down(resp["term"])
                    return
                self.next_index[pid] = self.storage.snapshot_index + 1
                self.match_index[pid] = self.storage.snapshot_index
                ni = self.next_index[pid]
            prev = ni - 1
            prev_term = self.storage.term_at(prev)
            if prev_term is None:
                prev_term = 0
            entries = [
                self.storage.entry_at(i)
                for i in range(ni, self.storage.last_index + 1)
            ]
            req = {
                "term": term,
                "leader_id": self.node_id,
                "prev_log_index": prev,
                "prev_log_term": prev_term,
                "entries": entries,
                "leader_commit": self.commit_index,
            }
        resp = self.transport.send(pid, "append_entries", req)
        with self._lock:
            if resp["term"] > self.storage.term:
                self._step_down(resp["term"])
                return
            if self.role != LEADER or self.storage.term != term:
                return
            if resp.get("success"):
                self.match_index[pid] = prev + len(entries)
                self.next_index[pid] = self.match_index[pid] + 1
                self.applied_index[pid] = max(
                    self.applied_index.get(pid, 0),
                    resp.get("applied", 0))
            else:
                # conflict: back up (use the follower's hint when present)
                hint = resp.get("conflict_index")
                self.next_index[pid] = max(
                    1, hint if hint else self.next_index[pid] - 1)

    def _advance_commit(self) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            quorum = self._quorum()
            for n in range(self.storage.last_index, self.commit_index, -1):
                if self.storage.term_at(n) != self.storage.term:
                    break  # only commit current-term entries by counting
                votes = 1 + sum(
                    1 for p in self.peer_ids
                    if self.match_index.get(p, 0) >= n)
                if votes >= quorum:
                    self.commit_index = n
                    break
            self._apply_committed()

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            idx = self.last_applied + 1
            entry = self.storage.entry_at(idx)
            if entry is None:  # inside snapshot: state already restored
                self.last_applied = idx
                continue
            data = entry["data"]
            result = None
            if isinstance(data, dict) and "_config" in data:
                # config entries mutate the ring, not the app state;
                # adoption already happened at append time
                result = dict(data["_config"]["members"])
            elif not (isinstance(data, dict) and data.get("_noop")):
                try:
                    result = self.apply_fn(data)
                except Exception as e:  # deterministic app error
                    result = e
            self.last_applied = idx
            self.metrics.counter("entries_applied").inc()
            if idx in self._waiters:
                self._results[idx] = result
        self.metrics.gauge("term").set(self.storage.term)
        self.metrics.gauge("commit_index").set(self.commit_index)
        self.metrics.gauge("last_applied").set(self.last_applied)
        self._commit_cv.notify_all()

    def _heard_from_leader_recently(self) -> bool:
        """Sticky-leader check (timer mode only): a node in live contact
        with a leader refuses to help depose it (Raft §4.2.3)."""
        return (
            self._timer_thread is not None
            and self.role == FOLLOWER
            and time.monotonic() - self._last_heartbeat
            < self.config.election_timeout_s[0]
        )

    # ----------------------------------------------------------- RPC handlers
    def handle_request_vote(self, req: dict) -> dict:
        with self._lock:
            if req.get("pre_vote"):
                # advisory only: no term change, no vote persisted, no
                # timer reset — just "would I vote for you?"
                last_index = self.storage.last_index
                last_term = self.storage.term_at(last_index) or 0
                granted = (
                    req["term"] >= self.storage.term
                    and self.role != LEADER
                    and not self._heard_from_leader_recently()
                    and (req["last_log_term"], req["last_log_index"])
                    >= (last_term, last_index)
                )
                return {"term": self.storage.term, "granted": granted}
            if req["term"] > self.storage.term and (
                    req.get("leadership_transfer")
                    or not self._heard_from_leader_recently()):
                # leadership_transfer: the leader itself sanctioned this
                # election, so the sticky-leader guard must not block it
                self._step_down(req["term"])
            granted = False
            if req["term"] == self.storage.term and self.storage.voted_for \
                    in (None, req["candidate_id"]):
                last_index = self.storage.last_index
                last_term = self.storage.term_at(last_index) or 0
                up_to_date = (req["last_log_term"], req["last_log_index"]) \
                    >= (last_term, last_index)
                if up_to_date:
                    granted = True
                    self.storage.voted_for = req["candidate_id"]
                    self.storage.persist_meta()
                    self._last_heartbeat = time.monotonic()
                    if self._timer_thread:
                        self._election_deadline = self._new_deadline()
                    if req.get("leadership_transfer") and \
                            self.leader_hint != req["candidate_id"]:
                        # the old leader sanctioned this election and is
                        # abdicating, so our current hint is going stale —
                        # but the candidate has NOT won yet (a competing
                        # higher term may still beat it), so advertising
                        # it could misdirect failover clients for a full
                        # heartbeat. Clear the hint; the real winner's
                        # first append_entries sets it authoritatively.
                        self.leader_hint = None
            return {"term": self.storage.term, "granted": granted}

    def handle_append_entries(self, req: dict) -> dict:
        with self._lock:
            if req["term"] > self.storage.term:
                self._step_down(req["term"])
            if req["term"] < self.storage.term:
                return {"term": self.storage.term, "success": False}
            self.role = FOLLOWER
            self.leader_hint = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            if self.on_lease_renewal is not None:
                try:
                    self.on_lease_renewal()
                except Exception:
                    log.exception("on_lease_renewal callback failed")
            if self._timer_thread:
                self._election_deadline = self._new_deadline()

            prev, prev_term = req["prev_log_index"], req["prev_log_term"]
            have = self.storage.term_at(prev)
            if have is None or have != prev_term:
                # conflict hint: first index of our conflicting term, or
                # one past our log end
                ci = min(prev, self.storage.last_index + 1)
                while ci > self.storage.snapshot_index + 1 and \
                        self.storage.term_at(ci - 1) == have and have is not None:
                    ci -= 1
                return {"term": self.storage.term, "success": False,
                        "conflict_index": max(1, ci)}

            idx = prev
            new = []
            truncated = False
            for e in req["entries"]:
                idx += 1
                mine = self.storage.term_at(idx)
                if mine is None:
                    new.append(e)
                elif mine != e["term"]:
                    self.storage.truncate_from(idx)
                    truncated = True
                    new.append(e)
                elif new:
                    new.append(e)  # already truncated past here
            if truncated:
                self._revert_config_after_truncate()
            if new:
                self.storage.append(new)
                base = self.storage.last_index - len(new)
                for off, e in enumerate(new):
                    d = e.get("data")
                    if isinstance(d, dict) and "_config" in d:
                        self._adopt_config(base + off + 1,
                                           d["_config"]["members"])
            if req["leader_commit"] > self.commit_index:
                self.commit_index = min(req["leader_commit"],
                                        self.storage.last_index)
                self._apply_committed()
            return {"term": self.storage.term, "success": True,
                    "applied": self.last_applied}

    def handle_install_snapshot(self, req: dict) -> dict:
        with self._lock:
            if req["term"] > self.storage.term:
                self._step_down(req["term"])
            if req["term"] < self.storage.term:
                return {"term": self.storage.term}
            self.role = FOLLOWER
            self.leader_hint = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            idx = req["last_included_index"]
            if idx > self.storage.snapshot_index:
                self.storage.install_snapshot(
                    idx, req["last_included_term"], req["data"],
                    members=req.get("members"))
                if req.get("members"):
                    # storage already persisted the shipped config
                    self._adopt_config(idx, req["members"], record=False)
                else:
                    # the wipe may have dropped configs above idx
                    self._revert_config_after_truncate()
                if self.restore_fn and req["data"] is not None:
                    self.restore_fn(req["data"])
                self.commit_index = max(self.commit_index, idx)
                self.last_applied = max(self.last_applied, idx)
            return {"term": self.storage.term}

    def handle_fetch_state(self, req: dict) -> dict:
        """Serve the current application state to a resyncing peer (the
        deposed-leader reconciliation path; role analog of the reference's
        follower bootstrap from a leader checkpoint). Leader-only so the
        state handed out is the committed line."""
        with self._lock:
            if self.role != LEADER or self.snapshot_fn is None:
                return {"ok": False, "term": self.storage.term}
            return {
                "ok": True,
                "term": self.storage.term,
                "applied": self.last_applied,
                "data": self.snapshot_fn(),
            }

    def fetch_state_from(self, peer_id: str) -> bool:
        """Pull the leader's full state and install it locally, discarding
        any divergent local application state (used after losing
        leadership with unreplicated local effects)."""
        resp = self.transport.send(peer_id, "fetch_state",
                                   {"requester": self.node_id})
        if not resp.get("ok"):
            return False
        with self._lock:
            applied = resp["applied"]
            if applied < self.storage.snapshot_index:
                # the leader hasn't applied past our compaction point
                # yet: older state could not be replayed forward from
                # the local log — retry on a later tick
                return False
            if self.restore_fn is not None:
                self.restore_fn(resp["data"])
            # the restored state IS the state at `applied`: move the
            # apply position to EXACTLY that point — even BACKWARD.
            # Entries this node applied while the fetch was in flight
            # were just reverted by the restore; keeping the old
            # position would skip their re-apply and silently lose
            # their effects on this replica alone (the single-replica
            # divergence window the soak's digest canary catches).
            self.last_applied = applied
            self.commit_index = max(self.commit_index, applied)
            self._apply_committed()  # replay the reverted tail now
        return True

    # ----------------------------------------------------------- maintenance
    def tick(self) -> None:
        """One deterministic heartbeat round (test mode)."""
        if self.role == LEADER:
            self._broadcast_heartbeat()

    def take_snapshot(self) -> None:
        """Compact the log behind a fresh application snapshot
        (ContainerStateMachine.takeSnapshot / Ratis snapshot analog)."""
        if self.snapshot_fn is None:
            return
        with self._lock:
            upto = self.last_applied
            term = self.storage.term_at(upto) or self.storage.term
            data = self.snapshot_fn()
            self.storage.compact(upto, term, data,
                                 self.config.snapshot_trailing)

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    @property
    def is_ready_leader(self) -> bool:
        """Leader AND caught up: the current term's no-op has applied, so
        every entry committed in prior terms is reflected in local state.
        Serving reads before this point would return stale data across a
        failover (a freshly elected leader may lag the old commit line)."""
        return self.role == LEADER and \
            self.last_applied >= self._leader_ready_index

    def follower_lease_valid(self, lease_s: float) -> bool:
        """True while this FOLLOWER's read lease is live: it heard an
        accepted append_entries within `lease_s`. Sound only for
        lease_s < min election timeout — within that window no other
        node can have won an election this follower never voted in, so
        no commit line exists that this replica is sealed off from
        (om/sharding/leases.py holds the staleness argument)."""
        return self.role == FOLLOWER and \
            time.monotonic() - self._last_heartbeat < lease_s

    def push_commit(self) -> None:
        """Leader-side commit push: one immediate heartbeat so
        followers learn the current commit index NOW instead of a
        heartbeat interval later. The follower-read freshness check
        (`min_applied`) would otherwise refuse every read issued within
        ~heartbeat_interval_s of the write that preceded it."""
        if self.role == LEADER:
            self._broadcast_heartbeat()


class Transport:
    """Abstract peer messaging: send(method in {request_vote,
    append_entries, install_snapshot})."""

    def register(self, node: RaftNode) -> None:
        raise NotImplementedError

    def send(self, peer_id: str, method: str, req: dict) -> dict:
        raise NotImplementedError


class InProcessTransport(Transport):
    """Direct in-process dispatch; one instance shared by a test cluster.

    A `partition` set of (a, b) pairs simulates network partitions for
    chaos tests (the blockade-test analog)."""

    def __init__(self):
        self.nodes: dict[str, RaftNode] = {}
        self.partitions: set[frozenset] = set()
        self.down: set[str] = set()

    def register(self, node: RaftNode) -> None:
        self.nodes[node.node_id] = node

    def partition(self, a: str, b: str) -> None:
        self.partitions.add(frozenset((a, b)))

    def heal(self) -> None:
        self.partitions.clear()
        self.down.clear()

    def send(self, peer_id: str, method: str, req: dict) -> dict:
        src = req.get("candidate_id") or req.get("leader_id") \
            or req.get("requester")
        if peer_id in self.down or src in self.down or (
                src and frozenset((src, peer_id)) in self.partitions):
            raise ConnectionError(f"{src} -/-> {peer_id}")
        node = self.nodes.get(peer_id)
        if node is None:
            raise ConnectionError(f"unknown peer {peer_id}")
        handler = getattr(node, f"handle_{method}")
        return handler(req)
