"""Two-phase cross-shard transactions: rename and bucket link.

Port of `ozone_tpu/om/sharding/txn.py`. The rare ops that span shard
rings (a key moving between buckets, a bucket link whose source lives
elsewhere) run a prepare/commit protocol with the decision journaled on
the root ring:

  begin (root) -> prepare on both shard rings -> decide (root)
       -> commit/abort on both shard rings -> end (root)

Every phase record is a replicated ring entry, so a coordinator crash at
any point is recoverable: `recover()` re-reads the root journal and
drives open transactions to their decided outcome, or aborts undecided
ones (presumed abort). The shard-side requests are idempotent on replay:
a commit or abort for a transaction whose intent row is gone is a no-op,
so recovery can re-drive a phase that may or may not have landed before
the crash.

All side effects that can fail (validation, quota) happen at prepare
time; commit and abort only resolve the staged intent, so a decided
transaction cannot wedge on a business-rule error. A renamed key's row
keeps its block groups: the data does not move. The source prepare and
the destination commit preserve the snapshot pre-images of the rows
they delete and write, as every mutating request does.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

from ozone_tpu_torch.om.metadata import bucket_key, key_key
from ozone_tpu_torch.om.requests import (
    BUCKET_NOT_FOUND,
    INVALID_REQUEST,
    KEY_NOT_FOUND,
    OMError,
    OMRequest,
    check_and_charge_quota,
    preserve_preimage,
)
from ozone_tpu_torch.om.sharding.shardmap import (
    SHARD_MOVED,
    ShardMap,
    check_shard,
)
from ozone_tpu_torch.utils.metrics import registry

METRICS = registry("om.shard")


def _intent_key(txn_id: str, op: str) -> str:
    # keyed per-op: when BOTH participants of a transaction land on the
    # same ring (same-shard cross-bucket rename) each stages its own row
    return f"txn_intent/{txn_id}/{op}"


def _journal_key(txn_id: str) -> str:
    return f"txn/{txn_id}"


@dataclass
class ShardPrepare(OMRequest):
    """Phase 1 on a participant ring: validate, stage an intent row,
    and take every charge that could fail (quota) — so the later
    commit cannot be refused. `epoch` is the coordinator's shard-map
    epoch: a participant whose replicated shard config has moved past
    it rejects the prepare (SHARD_MOVED) instead of staging state for
    a slot it may no longer own by commit time."""

    txn_id: str
    op: str  # rename_src | rename_dst | link_src | link_dst
    payload: dict
    epoch: int

    def apply(self, store):
        ik = _intent_key(self.txn_id, self.op)
        staged = store.get("system", ik)
        if staged is not None:
            return staged.get("result")  # log replay: already prepared
        cfg = store.get("system", "shard_config")
        if cfg is not None and self.epoch < cfg["epoch"]:
            raise OMError(
                SHARD_MOVED,
                f"prepare fenced: coordinator epoch {self.epoch} < "
                f"shard epoch {cfg['epoch']}")
        vol, bkt = self.payload["volume"], self.payload["bucket"]
        check_shard(store, vol, bkt)
        handler = getattr(self, f"_prepare_{self.op}", None)
        if handler is None:
            raise OMError(INVALID_REQUEST, f"unknown 2pc op {self.op!r}")
        result = handler(store, vol, bkt)
        store.put("system", ik,
                  {"op": self.op, "payload": self.payload,
                   "epoch": self.epoch, "result": result})
        return result

    # -- per-op prepare bodies (each returns the value the coordinator
    #    threads into the sibling prepare) ----------------------------
    def _prepare_rename_src(self, store, vol, bkt):
        src = key_key(vol, bkt, self.payload["key"])
        info = store.get("keys", src)
        if info is None:
            raise OMError(KEY_NOT_FOUND, src)
        preserve_preimage(store, vol, bkt, src)
        store.delete("keys", src)
        check_and_charge_quota(store, vol, bkt,
                               -int(info.get("size", 0)), -1)
        return info

    def _prepare_rename_dst(self, store, vol, bkt):
        bk = bucket_key(vol, bkt)
        brow = store.get("buckets", bk)
        if brow is None:
            raise OMError(BUCKET_NOT_FOUND, bk)
        if brow.get("source"):
            raise OMError(INVALID_REQUEST,
                          f"cannot rename into bucket link {bk}")
        dst = key_key(vol, bkt, self.payload["new_key"])
        if store.get("keys", dst) is not None:
            raise OMError(INVALID_REQUEST,
                          f"rename destination {dst} already exists")
        info = self.payload["info"]
        # growth charge at PREPARE: the only phase allowed to refuse
        check_and_charge_quota(store, vol, bkt,
                               int(info.get("size", 0)), 1)
        return True

    def _prepare_link_src(self, store, vol, bkt):
        bk = bucket_key(vol, bkt)
        brow = store.get("buckets", bk)
        if brow is None:
            raise OMError(BUCKET_NOT_FOUND, bk)
        return {"replication": brow.get("replication", ""),
                "layout": brow.get("layout", "")}

    def _prepare_link_dst(self, store, vol, bkt):
        bk = bucket_key(vol, bkt)
        if store.get("buckets", bk) is not None:
            raise OMError(INVALID_REQUEST,
                          f"bucket {bk} already exists")
        return True


@dataclass
class ShardCommit(OMRequest):
    """Phase 2 (decided COMMIT): resolve the staged intent. Deliberately
    unfenceable by epoch — once the root journal says commit, the shard
    holding the intent must resolve it even if the slot has since moved
    (the intent row, not the slot map, is the authority here); `epoch`
    is recorded for the audit trail."""

    txn_id: str
    epoch: int

    def apply(self, store):
        resolved = []
        prefix = f"txn_intent/{self.txn_id}/"
        for ik, staged in list(store.iterate("system", prefix)):
            op, payload = staged["op"], staged["payload"]
            vol, bkt = payload["volume"], payload["bucket"]
            if op == "rename_dst":
                info = dict(payload["info"])
                info["name"] = payload["new_key"]
                dst = key_key(vol, bkt, payload["new_key"])
                preserve_preimage(store, vol, bkt, dst)
                store.put("keys", dst, info)
            elif op == "link_dst":
                OMRequest.from_json(payload["request"]).apply(store)
            # rename_src / link_src: the prepare already did the work
            store.delete("system", ik)
            resolved.append(op)
        return resolved or None


@dataclass
class ShardAbort(OMRequest):
    """Phase 2 (decided ABORT or undecided at recovery): undo the
    staged intent. Like commit, never refused by epoch — recovery must
    be able to drain an intent wherever it sits."""

    txn_id: str
    epoch: int

    def apply(self, store):
        resolved = []
        prefix = f"txn_intent/{self.txn_id}/"
        for ik, staged in list(store.iterate("system", prefix)):
            op, payload = staged["op"], staged["payload"]
            vol, bkt = payload["volume"], payload["bucket"]
            if op == "rename_src":
                info = staged["result"]
                store.put("keys",
                          key_key(vol, bkt, payload["key"]), info)
                check_and_charge_quota(store, vol, bkt,
                                       int(info.get("size", 0)), 1)
            elif op == "rename_dst":
                info = payload["info"]
                check_and_charge_quota(store, vol, bkt,
                                       -int(info.get("size", 0)), -1)
            # link_src / link_dst: marker only
            store.delete("system", ik)
            resolved.append(op)
        return resolved or None


@dataclass
class TxnJournal(OMRequest):
    """Root-ring coordinator journal entry. Phases: begin ->
    decide-commit | decide-abort -> end (row deleted). The phase
    ordering is monotonic under replay: a stale `begin` cannot
    overwrite a recorded decision."""

    txn_id: str
    phase: str  # begin | decide-commit | decide-abort | end
    record: dict = field(default_factory=dict)

    _ORDER = {"begin": 0, "decide-abort": 1, "decide-commit": 1,
              "end": 2}

    def apply(self, store):
        jk = _journal_key(self.txn_id)
        cur = store.get("system", jk)
        if self.phase == "end":
            store.delete("system", jk)
            return None
        if cur is not None and \
                self._ORDER[cur["phase"]] >= self._ORDER[self.phase]:
            return cur  # replay of an earlier phase: keep the decision
        row = {"txn_id": self.txn_id, "phase": self.phase,
               "record": self.record or (cur or {}).get("record", {})}
        store.put("system", jk, row)
        return row


class CrossShardCoordinator:
    """Drives the 2PC above. Parameterized over submission callables so
    the same coordinator serves the in-process sharded plane and a
    daemon fronting real rings:

      root_submit(request)           -> replicated apply on the root ring
      shard_submit(shard_id, request)-> replicated apply on a shard ring
      root_store                     -> the root ring's local store
                                        (recovery scans the journal)
    """

    def __init__(self, root_submit: Callable[[OMRequest], Any],
                 shard_submit: Callable[[str, OMRequest], Any],
                 root_store,
                 map_fn: Callable[[], ShardMap]):
        self._root_submit = root_submit
        self._shard_submit = shard_submit
        self._root_store = root_store
        self._map_fn = map_fn
        self.metrics = METRICS

    # -- public ops ----------------------------------------------------
    def rename_cross(self, volume: str, src_bucket: str, key: str,
                     dst_bucket: str, new_key: str) -> dict:
        """Move a key between buckets (possibly between shards):
        returns the moved key info."""
        m = self._map_fn()
        s_src = m.shard_for(volume, src_bucket)
        s_dst = m.shard_for(volume, dst_bucket)
        txn_id = uuid.uuid4().hex
        record = {"kind": "rename", "volume": volume,
                  "src_bucket": src_bucket, "key": key,
                  "dst_bucket": dst_bucket, "new_key": new_key,
                  "src_shard": s_src, "dst_shard": s_dst,
                  "epoch": m.epoch}
        self._root_submit(TxnJournal(txn_id, "begin", record))
        try:
            info = self._shard_submit(s_src, ShardPrepare(
                txn_id, "rename_src",
                {"volume": volume, "bucket": src_bucket, "key": key},
                epoch=m.epoch))
            self.metrics.counter("cross_shard_prepares").inc()
            self._shard_submit(s_dst, ShardPrepare(
                txn_id, "rename_dst",
                {"volume": volume, "bucket": dst_bucket,
                 "new_key": new_key, "info": info},
                epoch=m.epoch))
            self.metrics.counter("cross_shard_prepares").inc()
        except Exception:
            self._abort(txn_id, record, m.epoch, (s_src, s_dst))
            raise
        self._root_submit(TxnJournal(txn_id, "decide-commit", record))
        self._commit(txn_id, m.epoch, (s_src, s_dst))
        info = dict(info)
        info["name"] = new_key
        return info

    def link_bucket_cross(self, create_bucket_request) -> None:
        """Create a bucket link whose SOURCE bucket lives on another
        shard: validate the source there, stage the CreateBucket on the
        link's own shard, then commit both."""
        rq = create_bucket_request
        m = self._map_fn()
        s_src = m.shard_for(rq.source_volume, rq.source_bucket)
        s_dst = m.shard_for(rq.volume, rq.bucket)
        txn_id = uuid.uuid4().hex
        record = {"kind": "link", "volume": rq.volume,
                  "bucket": rq.bucket,
                  "source_volume": rq.source_volume,
                  "source_bucket": rq.source_bucket,
                  "src_shard": s_src, "dst_shard": s_dst,
                  "epoch": m.epoch}
        self._root_submit(TxnJournal(txn_id, "begin", record))
        try:
            self._shard_submit(s_src, ShardPrepare(
                txn_id, "link_src",
                {"volume": rq.source_volume,
                 "bucket": rq.source_bucket},
                epoch=m.epoch))
            self.metrics.counter("cross_shard_prepares").inc()
            self._shard_submit(s_dst, ShardPrepare(
                txn_id, "link_dst",
                {"volume": rq.volume, "bucket": rq.bucket,
                 "request": rq.to_json()},
                epoch=m.epoch))
            self.metrics.counter("cross_shard_prepares").inc()
        except Exception:
            self._abort(txn_id, record, m.epoch, (s_src, s_dst))
            raise
        self._root_submit(TxnJournal(txn_id, "decide-commit", record))
        self._commit(txn_id, m.epoch, (s_src, s_dst))

    # -- phase 2 drivers ----------------------------------------------
    def _commit(self, txn_id: str, epoch: int,
                shards: tuple[str, str]) -> None:
        for sid in dict.fromkeys(shards):  # dedupe, keep order
            self._shard_submit(sid, ShardCommit(txn_id, epoch=epoch))
        self.metrics.counter("cross_shard_commits").inc()
        self._root_submit(TxnJournal(txn_id, "end"))

    def _abort(self, txn_id: str, record: dict, epoch: int,
               shards: tuple[str, str]) -> None:
        self._root_submit(TxnJournal(txn_id, "decide-abort", record))
        done = True
        for sid in dict.fromkeys(shards):
            try:
                self._shard_submit(sid, ShardAbort(txn_id, epoch=epoch))
            except Exception:
                # participant unreachable: the decision is journaled;
                # recovery re-drives this abort when the shard returns
                done = False
        self.metrics.counter("cross_shard_aborts").inc()
        if done:
            self._root_submit(TxnJournal(txn_id, "end"))

    # -- crash recovery ------------------------------------------------
    def recover(self) -> list[dict]:
        """Drive every open journal entry to its decided outcome:
        decide-commit -> commit everywhere; begin / decide-abort ->
        abort everywhere (presumed abort for the undecided). Returns
        the resolved records."""
        resolved = []
        for _, row in list(self._root_store.iterate("system", "txn/")):
            txn_id, phase = row["txn_id"], row["phase"]
            rec = row.get("record", {})
            shards = tuple(s for s in (rec.get("src_shard"),
                                       rec.get("dst_shard")) if s)
            epoch = int(rec.get("epoch", 0))
            if phase == "decide-commit":
                self._commit(txn_id, epoch, shards)
            else:
                self._abort(txn_id, rec, epoch, shards)
            resolved.append({"txn_id": txn_id, "phase": phase, **rec})
        return resolved
