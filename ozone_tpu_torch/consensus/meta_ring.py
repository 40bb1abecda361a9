"""One raft ring for the whole metadata process (OM and SCM state).

Port of `ozone_tpu/consensus/meta_ring.py`. The reference runs OM HA and
SCM HA as two Ratis rings because OM and SCM are separate processes;
here they share one metadata daemon (`net/daemons.ScmOmDaemon`), so HA
is one ring replicating both: OM client requests ride the log as
`{"om": <request json>}` entries (the OzoneManagerStateMachine
.applyTransaction analog) and SCM container mutations as the leader's
decision records (inherited from `scm/ha.RaftSCM`). One ring means one
leader for both roles.

A request (`submit_om`): preExecute on the ready leader (block
allocation emits SCM decision records), propose the OM request, and
acknowledge only after the OM entry and every SCM record the call made
are quorum-committed. Followers apply the same entries in log order.
The durable applied floor, the OM-store row `system/raft_applied`,
rides the same sqlite batch as the entry's rows, so a restart never
applies a non-idempotent entry (a versioned CommitKeys) twice. The ring
also serves the replicated `om prepare` and the operator verbs
`ring_add`, `ring_remove`, `ring_transfer` and `ring_status`. With
`push_commit_on_write` (the sharded plane's follower-read rings) the
leader pushes the commit index to its followers right after each write.
Admission checks the layout-feature gate (`OzoneManager.
check_layout_allowed`) on the leader, as the standalone submit does;
followers apply what the leader admitted.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

from ozone_tpu_torch.consensus.raft import NotRaftLeaderError
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.scm.ha import RaftSCM
from ozone_tpu_torch.scm.scm import StorageContainerManager

log = logging.getLogger(__name__)


class MetaHARing(RaftSCM):
    """RaftSCM (decision-record replication, resync, ack tracking) plus
    OM request replication on the same RaftNode."""

    def __init__(self, om: OzoneManager, scm: StorageContainerManager,
                 raft_dir: Path, node_id: str, peer_ids: list[str],
                 transport=None, config=None, ack_timeout_s: float = 30.0):
        self.om = om  # before super(): RaftNode restore may fire in init
        # durable applied floor: restart replays the raft log from the
        # snapshot point, but the OM sqlite may already hold the effects
        # of entries flushed before the crash — re-applying those would
        # duplicate non-idempotent effects (e.g. versioned CommitKeys).
        # The floor rides the OM store's own batch, so it is exactly as
        # current as the data it guards.
        row = om.store.get("system", "raft_applied")
        self._applied_floor = int(row["index"]) if row else 0
        super().__init__(scm, raft_dir, node_id, peer_ids,
                         transport=transport, config=config,
                         ack_timeout_s=ack_timeout_s)
        # the ring snapshots/restores the whole metadata process, not
        # just SCM container state
        self.node.snapshot_fn = self._snapshot_all
        self.node.restore_fn = self._restore_all
        # follower-read admission (om/sharding/leases.py): any replica
        # holding a live read lease may answer read verbs locally
        from ozone_tpu_torch.om.sharding.leases import (
            READ_LEASE_S,
            FollowerReadGate,
        )

        self.read_gate = FollowerReadGate(self.node, READ_LEASE_S)
        _renewals = self.read_gate.metrics.counter("lease_renewals")
        self.node.on_lease_renewal = _renewals.inc
        #: push the commit index to followers right after each write
        #: commits (one extra heartbeat), so their read leases serve
        #: fresh state instead of refusing on min_applied for a whole
        #: heartbeat interval. Opt-in: the sharded plane sets it.
        self.push_commit_on_write = False

    # ------------------------------------------------------------- apply
    def _apply(self, data: dict) -> Any:
        # exact: _apply_committed holds the node lock and bumps
        # last_applied right after this callback returns
        idx = self.node.last_applied + 1
        if idx <= self._applied_floor:
            return None  # already durably applied before the restart
        # atomic: this entry's mutations AND its raft_applied marker
        # land in the same durable batch — a crash can neither tear a
        # multi-row apply (lost-rename class) nor persist a marker
        # ahead of its entry's rows (replay would skip a half-applied
        # entry forever)
        with self.om.store.atomic():
            return self._apply_entry(data, idx)

    def _apply_entry(self, data: dict, idx: int) -> Any:
        if "om" in data:
            if self.om.prepared:
                # deterministic by log position: every entry after the
                # om_prepare marker converges to the same rejection on
                # every replica (a write proposed concurrently with the
                # marker must not apply behind the operator's back)
                result = rq.OMError(
                    "OM_PREPARED",
                    "OM is prepared for upgrade; writes are rejected "
                    "until cancelprepare")
            else:
                try:
                    result = rq.OMRequest.from_json(data["om"]).apply(
                        self.om.store)
                except rq.OMError as e:
                    result = e  # deterministic: replicas converge on it
        elif "admin" in data:
            # replicated operator decision (decommission/safemode/
            # balancer): applied on every replica so it survives failover
            result = self.scm.apply_admin_op(
                data["admin"]["op"], data["admin"].get("target"))
        elif "om_prepare" in data:
            # coordinated upgrade quiesce: every replica durably flushes
            # and rejects writes (the OzoneManagerPrepareState marker).
            # Called UNBOUND: the daemon patches the instance's prepare
            # to the ring's leader entry point, and apply must run the
            # local state change, not re-propose.
            if data["om_prepare"]:
                result = OzoneManager.prepare(self.om)
            else:
                OzoneManager.cancel_prepare(self.om)
                result = None
        else:
            result = super()._apply(data)
        self._applied_floor = idx
        self.om.store.put("system", "raft_applied", {"index": idx})
        if idx % 256 == 0:
            # replica-divergence canary: every replica logs a
            # deterministic digest of its OM keys table at the same log
            # positions, so a silent state divergence shows as a
            # grep-able first-mismatch window
            log.info("state-digest node=%s idx=%d keys=%s",
                     self.scm_id, idx, self._keys_digest())
        return result

    def _keys_digest(self) -> str:
        """Deterministic digest of the keys table (rows are replicated
        verbatim, so equal states digest equal across replicas). O(1):
        the store maintains the digest incrementally per mutation —
        the canary must not stall the serialized apply path with an
        O(table) rescan every 256 writes."""
        return self.om.store.table_digest("keys")

    def _snapshot_all(self) -> dict:
        return {
            "om": self.om.store.export_state(),
            "scm": self.scm.containers.snapshot_state(),
        }

    def _restore_all(self, snap: dict) -> None:
        if "om" in snap:
            self.om.store.import_state(snap["om"])
            # the durable quiesce marker rides the system table: refresh
            # the cached flag so a snapshot-installed replica agrees with
            # its peers on prepared state
            self.om.reload_prepared()
            # CRITICAL: the replay floor must be re-derived from the
            # RESTORED store, not kept from the pre-restore sqlite. At
            # restart the node restores its last COMPACTION snapshot —
            # usually OLDER than the sqlite state — and replays the log
            # forward; a floor captured before the revert would skip
            # every entry between the snapshot point and the old floor,
            # silently LOSING that whole window of acked writes (the
            # window of acknowledged writes)
            row = self.om.store.get("system", "raft_applied")
            self._applied_floor = int(row["index"]) if row else 0
        if "scm" in snap:
            self.scm.containers.install_snapshot(snap["scm"])

    def _restore(self, snap: dict) -> None:
        # RaftNode init / install_snapshot path: handle both the combined
        # form and a bare SCM snapshot (pre-ring state)
        if "om" in snap or "scm" in snap:
            self._restore_all(snap)
        else:
            super()._restore(snap)

    # ------------------------------------------------------------ serving
    @property
    def is_ready(self) -> bool:
        """Leader with the current term's no-op applied — safe to serve
        reads and run preExecute against local state."""
        return self.node.is_ready_leader

    def submit_om(self, request: rq.OMRequest) -> Any:
        """OzoneManager.submit through the ring (the OzoneManagerRatis
        Server.submitRequest analog). Audit/metrics stay with the caller
        (the daemon patches om.submit to this)."""
        if not self.node.is_ready_leader:
            # not-yet-ready leaders bounce too: preExecute reads local
            # state, which may lag the committed line until the no-op
            # applies (clients retry through the failover proxy)
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        if self.om.prepared:
            raise rq.OMError(
                "OM_PREPARED",
                "OM is prepared for upgrade; writes are rejected until "
                "cancelprepare")
        # the layout gate at the standalone submit's admission point:
        # only the leader admits, so a mixed-version ring stays
        # deterministic
        self.om.check_layout_allowed(type(request).__name__)
        from ozone_tpu_torch.utils.tracing import Tracer

        with Tracer.instance().span("om:submit",
                                    request=type(request).__name__,
                                    ha=True):
            request.pre_execute(self.om)
            result = self.node.propose({"om": request.to_json()})
            # block allocation in preExecute produced SCM decision
            # records; the client ack covers them too
            self._await_records()
        if self.push_commit_on_write:
            self.node.push_commit()
        if isinstance(result, Exception):
            raise result
        return result

    def prepare_om(self) -> int:
        """Replicated `om prepare`: every replica flushes + quiesces."""
        if not self.node.is_ready_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        result = self.node.propose({"om_prepare": True})
        if isinstance(result, Exception):
            raise result
        return result

    def cancel_prepare_om(self) -> None:
        if not self.node.is_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        result = self.node.propose({"om_prepare": False})
        if isinstance(result, Exception):
            raise result

    def submit_admin(self, op: str, target=None) -> dict:
        """Replicate a mutating admin op (the SCMRatisRequest shape for
        operator decisions): applied on every replica in log order."""
        if not self.node.is_ready_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        result = self.node.propose({"admin": {"op": op, "target": target}})
        if isinstance(result, Exception):
            raise result
        return result

    # -------------------------------------------------------- membership
    def ring_add(self, node_id: str, address: str) -> dict:
        """Grow the metadata ring by one replica (OM bootstrap /
        Ratis setConfiguration analog): the new node starts as an empty
        follower, the config entry admits it, and the leader catches it
        up via snapshot-install + log replay."""
        if not self.node.is_ready_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        return self.node.change_membership(add=node_id, address=address)

    def ring_remove(self, node_id: str) -> dict:
        """Retire one replica (decommission-OM analog)."""
        if not self.node.is_ready_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        return self.node.change_membership(remove=node_id)

    def ring_transfer(self, node_id: str) -> dict:
        """Planned leadership hand-off (`ozone admin om transfer
        --node` / Ratis TransferLeadership analog)."""
        if not self.node.is_ready_leader:
            raise NotRaftLeaderError(self.scm_id, self.node.leader_hint)
        ok = self.node.transfer_leadership(node_id)
        return {"transferred": ok, "target": node_id,
                "leader_hint": self.node.leader_hint}

    def ring_status(self) -> dict:
        """This replica's view of the ring (ozone admin om roles /
        scm roles analog): answered by ANY replica — operators ask a
        follower who the leader is."""
        n = self.node
        return {
            "replica_id": self.scm_id,
            "role": "LEADER" if n.is_leader else "FOLLOWER",
            "term": n.storage.term,
            "last_applied": n.last_applied,
            "leader": (self.scm_id if n.is_leader
                       else (n.leader_hint or None)),
            "members": sorted([*n.peer_ids, self.scm_id]),
        }

    @property
    def leader_hint(self):
        return self.node.leader_hint
