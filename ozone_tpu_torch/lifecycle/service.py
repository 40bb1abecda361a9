"""LifecycleService: the term-fenced, resumable background sweeper.

Port of `ozone_tpu/lifecycle/service.py`, whole. Exactly-once across a
crash of the sweeper comes from three properties:

1. **Term fencing**: every cursor checkpoint carries the sweeper's
   fencing term, and the deterministic apply
   (`om/requests.LifecycleCheckpoint`) rejects any checkpoint whose term
   is not the fenced one. Under HA the metadata daemon passes the ring's
   raft term and its readiness as leader; standalone, `term_fn` answers
   0. The rejection codes are the reference's at every term.
2. **Transitions commit before the cursor does**: a crash between the
   two re-scans at most one page, and re-scans are harmless (a
   transitioned key is EC and no longer matches; an expired key has no
   row).
3. **The rewrite fence** on each transition commit: a re-scan or a
   concurrent user overwrite loses deterministically (KEY_MODIFIED).

Each sweep runs under one `client/resilience.py` deadline (the per-sweep
budget) with source reads paced by a `utils/throttle.py` token bucket.
`compact_slabs_once` is the needle compaction of the small-object path:
survivors of a slab past the dead-ratio knob are rewritten into a fresh
slab through `client/slab.SlabPacker`, then the old slab row is retired
and its blocks go to the SCM's deletion log; a bucket with snapshots is
skipped, since its snapshots' rows may still name the slab's blocks.
The codec runs on `device`. The sweep skips FILE_SYSTEM_OPTIMIZED
buckets, as the reference's does: its prefix rules read the flat key
table, which an FSO bucket does not fill.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.lifecycle.policy import (
    ACTION_EXPIRE,
    ACTION_TRANSITION,
    LifecycleRule,
    first_match,
)
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import bucket_key
from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.metrics import registry

log = logging.getLogger(__name__)

METRICS = registry("lifecycle")

#: default per-sweep wall-clock budget (seconds);
#: OZONE_TPU_LIFECYCLE_DEADLINE_S overrides, 0 = unbounded
DEFAULT_SWEEP_DEADLINE_S = 300.0


class LifecycleFenced(Exception):
    """This sweeper's term was fenced out by a newer leader."""


class LifecycleService:
    """Policy-driven hot->warm tiering + TTL expiration sweeper.

    ``term_fn`` returns the fencing term (the metadata ring's raft term
    under HA; 0 standalone). ``leader_fn`` gates each sweep — only the
    ring leader runs background mutators, like every other OM service.
    ``clients_fn`` resolves the datanode client factory lazily (daemons
    learn datanode addresses from heartbeats, after construction).
    """

    STATE_KEY = "lifecycle_state"

    def __init__(self, om, clients=None, clients_fn=None,
                 term_fn: Optional[Callable[[], int]] = None,
                 leader_fn: Optional[Callable[[], bool]] = None,
                 throttle=None, page: int = 256, batch_keys: int = 128,
                 sweep_deadline_s: Optional[float] = None,
                 device="cuda",
                 alloc_barrier: Optional[Callable] = None):
        self.om = om
        #: where the tiering encode and the compaction's slab flush run
        #: (resolved at the first sweep that needs it)
        self.device = device
        self._clients = clients
        self._clients_fn = clients_fn
        self.term_fn = term_fn or (lambda: 0)
        self.leader_fn = leader_fn or (lambda: True)
        self.throttle = throttle
        self.page = page
        self.batch_keys = batch_keys
        if sweep_deadline_s is None:
            from ozone_tpu_torch.utils.config import env_float

            sweep_deadline_s = env_float(
                "OZONE_TPU_LIFECYCLE_DEADLINE_S",
                DEFAULT_SWEEP_DEADLINE_S)
        self.sweep_deadline_s = sweep_deadline_s
        #: HA quorum barrier after block allocations (the SCM decision
        #: records must commit before data lands on them)
        self.alloc_barrier = alloc_barrier
        self._fenced_term: Optional[int] = None
        self._executor = None
        # one sweep at a time per service: a run-now RPC racing the
        # daemon's background cadence would interleave same-term cursor
        # checkpoints (harmless — re-scans are idempotent — but wasted
        # work and confusing stats)
        self._sweep_lock = threading.Lock()

    # ------------------------------------------------------------- plumbing
    def clients(self):
        if self._clients_fn is not None:
            return self._clients_fn()
        return self._clients

    def executor(self):
        from ozone_tpu_torch.lifecycle.executor import TieringExecutor

        clients = self.clients()
        if self._executor is None or self._executor.clients is not clients:
            self._executor = TieringExecutor(self.om, clients,
                                             throttle=self.throttle,
                                             device=self.device)
            self._executor.alloc_barrier = self.alloc_barrier
        return self._executor

    def state(self) -> dict:
        return self.om.store.get("system", self.STATE_KEY) or {}

    def _checkpoint(self, term: int, cursor: dict,
                    stats: Optional[dict] = None,
                    fence: bool = False) -> None:
        try:
            self.om.submit(rq.LifecycleCheckpoint(
                term=term, cursor=cursor, stats=stats or {},
                fence=fence))
        except rq.OMError as e:
            if e.code == rq.LIFECYCLE_FENCED:
                METRICS.counter("leader_fences").inc()
                raise LifecycleFenced(str(e))
            raise

    def _fence(self, term: int) -> None:
        """Claim the sweeper role for this term (idempotent per term):
        after this commits, checkpoints from any OLDER term are
        deterministically rejected on every replica."""
        if self._fenced_term == term:
            return
        self._checkpoint(term, cursor=self.state().get("cursor", {}),
                         fence=True)
        self._fenced_term = term

    # --------------------------------------------------------------- sweep
    def _bucket_rules(self) -> list[tuple[str, dict, list[LifecycleRule]]]:
        out = []
        for bk, brow in self.om.store.iterate("buckets"):
            raw = brow.get("lifecycle") or []
            if not raw:
                continue
            if brow.get("layout") == "FILE_SYSTEM_OPTIMIZED":
                # FSO namespaces key files by parent id, not by path;
                # prefix rules over the flat scan don't apply (PARITY:
                # lifecycle covers OBS/LEGACY buckets)
                continue
            try:
                rules = [LifecycleRule.from_json(d) for d in raw]
            except ValueError as e:
                log.warning("lifecycle: bucket %s has invalid rules "
                            "(%s); skipping", bk, e)
                continue
            out.append((bk, brow, rules))
        return out

    def run_once(self, now: Optional[float] = None,
                 max_keys: Optional[int] = None) -> dict:
        """One sweep over every bucket with lifecycle rules, resuming
        from the replicated cursor; returns the sweep's stats. Safe to
        call on any node — followers return {"skipped": "not_leader"}.
        `max_keys` bounds the scan (tests / incremental ticks); an
        exhausted budget or key cap leaves the cursor mid-namespace and
        the next call resumes there."""
        if not self.leader_fn():
            return {"skipped": "not_leader"}
        if not self._sweep_lock.acquire(blocking=False):
            return {"skipped": "sweep_in_progress"}
        try:
            return self._run_once_locked(now, max_keys)
        finally:
            self._sweep_lock.release()

    def _run_once_locked(self, now: Optional[float],
                         max_keys: Optional[int]) -> dict:
        term = int(self.term_fn())
        stats = {"keys_scanned": 0, "transitioned": 0, "conflicts": 0,
                 "failed": 0, "expired": 0, "skipped": 0, "bytes": 0,
                 "dispatches": 0, "complete": False}
        t0 = time.monotonic()
        try:
            with resilience.start("lifecycle_sweep",
                                  seconds=self.sweep_deadline_s):
                self._fence(term)
                self._sweep(term, now or time.time(), stats, max_keys)
        except LifecycleFenced:
            stats["fenced"] = True
            log.info("lifecycle: sweeper fenced out (term %d)", term)
        except StorageError as e:
            if e.code != resilience.DEADLINE_EXCEEDED:
                raise
            stats["deadline_exceeded"] = True
        dt = time.monotonic() - t0
        METRICS.histogram("sweep_seconds").observe(dt)
        METRICS.counter("sweeps").inc()
        if stats["complete"]:
            # push freshly superseded replicated blocks into the SCM
            # deletion chain promptly (the commit already queued them
            # in the deleted table; this is the normal purge path)
            try:
                self.om.run_key_deleting_service_once()
            except Exception:  # noqa: BLE001 - purge retries next pass
                log.debug("lifecycle: post-sweep purge pass failed",
                          exc_info=True)
        return stats

    def _sweep(self, term: int, now: float, stats: dict,
               max_keys: Optional[int]) -> None:
        buckets = self._bucket_rules()
        cursor = dict(self.state().get("cursor") or {})
        resume_bk = cursor.get("bucket", "")
        after = cursor.get("after", "")
        for bk, brow, rules in sorted(buckets, key=lambda x: x[0]):
            if resume_bk and bk < resume_bk:
                continue  # finished in an earlier (possibly killed) sweep
            if bk != resume_bk:
                after = ""
            if not self._sweep_bucket(term, now, bk, brow, rules, after,
                                      stats, max_keys):
                return  # budget/cap hit; cursor already committed
        stats["complete"] = True
        self._checkpoint(term, cursor={},
                         stats=self._stats_row(stats, now))

    def _sweep_bucket(self, term: int, now: float, bk: str, brow: dict,
                      rules: list[LifecycleRule], after: str,
                      stats: dict, max_keys: Optional[int]) -> bool:
        """Scan one bucket's keys from `after`; returns False when the
        sweep must stop (key cap). Deadline expiry raises through."""
        volume, bucket = brow["volume"], brow["name"]
        base = bk + "/"
        while True:
            # the sweep budget binds the SCAN/EXPIRE path too, not just
            # the executor: a million-key bucket with only an EXPIRE
            # rule must still yield the shared background loop
            resilience.check_deadline("lifecycle_page")
            rows = self.om.store.iterate_range(
                "keys", base, start_after=(base + after) if after else "",
                limit=self.page)
            work: list[tuple] = []
            for full_key, info in rows:
                after = full_key[len(base):]
                stats["keys_scanned"] += 1
                METRICS.counter("keys_scanned").inc()
                self._evaluate(now, volume, bucket, after, info, rules,
                               work, stats)
                if max_keys is not None \
                        and stats["keys_scanned"] >= max_keys:
                    break
            for i in range(0, len(work), self.batch_keys):
                try:
                    ex_stats = self.executor().transition_keys(
                        work[i:i + self.batch_keys])
                except StorageError as e:
                    # budget spent mid-batch: book what DID land, then
                    # propagate WITHOUT checkpointing this page — the
                    # unprocessed remainder must be re-scanned, not
                    # skipped behind an advanced cursor
                    part = getattr(e, "stats", None)
                    if part:
                        for k in ("transitioned", "conflicts", "failed",
                                  "skipped", "bytes", "dispatches"):
                            stats[k] += part[k]
                    raise
                for k in ("transitioned", "conflicts", "failed",
                          "skipped", "bytes", "dispatches"):
                    stats[k] += ex_stats[k]
            # commit the cursor AFTER this page's transitions acked:
            # a kill -9 here re-scans at most this page, and re-scans
            # are idempotent (EC keys no longer match, expired rows
            # are gone, the rewrite fence kills any double-commit)
            self._checkpoint(term, cursor={"bucket": bk, "after": after},
                             stats=self._stats_row(stats, now))
            if max_keys is not None and stats["keys_scanned"] >= max_keys:
                return False
            if len(rows) < self.page:
                return True

    def _evaluate(self, now: float, volume: str, bucket: str, key: str,
                  info: dict, rules: list[LifecycleRule],
                  work: list, stats: dict) -> None:
        if info.get("hsync_client_id"):
            return  # live hsync stream: not cold by definition
        if not info.get("block_groups"):
            return  # directory markers / empty keys never tier or expire
        age_s = now - float(info.get("created", now))
        rule = first_match(rules, key, age_s)
        if rule is None:
            return
        if rule.action == ACTION_EXPIRE:
            try:
                # fenced on the SCANNED version: a user overwrite
                # racing the sweep wins (KEY_MODIFIED), same contract
                # as the transition path's rewrite fence
                self.om.submit(rq.DeleteKey(
                    volume, bucket, key,
                    expect_object_id=info.get("object_id", "")))
                stats["expired"] += 1
                METRICS.counter("expirations").inc()
            except rq.OMError as e:
                if e.code not in (rq.KEY_NOT_FOUND, rq.KEY_MODIFIED):
                    raise
            return
        # TRANSITION_TO_EC: only non-RS sources are eligible (RS keys
        # are already warm; the executor re-checks under the fence)
        try:
            repl = ReplicationConfig.parse(info.get("replication", ""))
        except ValueError:
            return
        if repl.type is ReplicationType.EC and repl.ec.codec != "xor":
            return
        work.append((volume, bucket, key, rule.target))

    # -------------------------------------------------- needle compaction
    def compact_slabs_once(self, max_slabs: Optional[int] = None) -> dict:
        """One needle-compaction sweep (the f4 volume-compaction analog):
        scan slab rows for dead-needle ratio past the knob
        (OZONE_TPU_SLAB_DEAD_RATIO, default 0.5), rewrite the survivors
        into a fresh slab through the codec service at bulk QoS with
        per-key rewrite fences, then retire the old slab and hand its
        blocks to scm/block_deletion — only AFTER the new commit acked,
        the same release ordering as tiering. Snapshotted buckets are
        skipped: their slab blocks may be referenced by snapshot rows."""
        if not self.leader_fn():
            return {"skipped": "not_leader"}
        from ozone_tpu_torch.utils.config import env_float
        from ozone_tpu_torch.client.slab import METRICS as SMALLOBJ

        dead_ratio = env_float("OZONE_TPU_SLAB_DEAD_RATIO", 0.5)
        stats = {"slabs_scanned": 0, "compacted": 0, "skipped": 0,
                 "conflicts": 0, "needles_rewritten": 0,
                 "bytes_rewritten": 0, "blocks_released": 0}
        candidates = []
        for sk, srow in list(self.om.store.iterate("slabs")):
            stats["slabs_scanned"] += 1
            length = max(1, int(srow.get("length", 0)))
            dead = int(srow.get("dead_bytes", 0))
            n_dead = int(srow.get("dead_count", 0))
            if (dead / length >= dead_ratio
                    or n_dead >= len(srow.get("needles", {}))):
                candidates.append(srow)
        with resilience.start("slab_compaction",
                              seconds=self.sweep_deadline_s):
            for srow in candidates[:max_slabs]:
                resilience.check_deadline("slab_compaction")
                if rq.bucket_snapshots(self.om.store, srow["volume"],
                                       srow["bucket"]):
                    stats["skipped"] += 1
                    continue
                try:
                    self._compact_slab(srow, stats)
                except (rq.OMError, StorageError, OSError, KeyError) as e:
                    log.warning("lifecycle: compaction of slab %s "
                                "failed: %s", srow["slab_id"], e)
                    stats["skipped"] += 1
        SMALLOBJ.counter("compaction_slabs").inc(stats["compacted"])
        SMALLOBJ.counter("compaction_bytes").inc(stats["bytes_rewritten"])
        SMALLOBJ.counter("compaction_conflicts").inc(stats["conflicts"])
        return stats

    def _compact_slab(self, srow: dict, stats: dict) -> None:
        from ozone_tpu_torch.client.slab import SlabPacker
        from ozone_tpu_torch.om.metadata import key_key
        from ozone_tpu_torch.utils.checksum import crc32c

        vol, bkt, sid = srow["volume"], srow["bucket"], srow["slab_id"]
        # survivors: needles whose LIVE key row still points at this
        # slab with the recorded object id (anything else — deleted,
        # overwritten, already re-homed — is dead weight)
        survivors = []
        for key, nd in sorted(srow.get("needles", {}).items()):
            row = self.om.store.get("keys", key_key(vol, bkt, key))
            if (row is not None and row.get("needle")
                    and row["needle"].get("slab") == sid
                    and row.get("object_id") == nd.get("oid")):
                survivors.append((key, row))
        if survivors:
            data = {}
            for key, row in survivors:
                nd = row["needle"]
                raw = self._read_slab_range(srow, int(nd["offset"]),
                                            int(nd["length"]))
                if int(crc32c(raw)) != int(nd["crc"]):
                    raise StorageError(
                        "CHECKSUM_MISMATCH",
                        f"survivor {key} of slab {sid} fails its CRC")
                data[key] = raw
            # pack the survivors into a fresh slab via the packer's
            # write path (bulk QoS, shared codec service), fenced on the
            # exact versions we read — a racing user overwrite wins and
            # its needle simply counts dead in the NEW slab
            packer = SlabPacker(self.om, self.clients(),
                                qos_class="bulk", device=self.device)
            from ozone_tpu_torch.client.slab import _BucketQueue, _Pending

            q = _BucketQueue(vol, bkt, srow["replication"])
            for key, row in survivors:
                p = _Pending(key, bytes(data[key].tobytes()), None)
                q.items.append(p)
                q.nbytes += len(p.data)
            out = packer._write_and_commit_fenced(
                q, [(row.get("object_id", ""),
                     int(row.get("generation", -1)))
                    for _, row in survivors])
            stats["conflicts"] += len(out.get("skipped", ()))
            stats["needles_rewritten"] += len(out.get("committed", ()))
            stats["bytes_rewritten"] += sum(
                len(v) for k, v in data.items()
                if k in set(out.get("committed", ())))
        # retire the old slab row, THEN release its blocks: the blocks
        # outlive every committed pointer at them, never the reverse
        old = self.om.submit(rq.RetireSlab(vol, bkt, sid))
        from ozone_tpu_torch.client.slab import METRICS as SMALLOBJ
        from ozone_tpu_torch.storage.ids import BlockID

        txs = []
        for gj in old.get("block_groups", []):
            txs.append((BlockID(gj["container_id"], gj["local_id"]),
                        list(gj["nodes"])))
        if txs:
            with self.om.scm_lock:
                self.om.scm.delete_blocks(txs)
            stats["blocks_released"] += len(txs)
        stats["compacted"] += 1
        SMALLOBJ.counter("slabs_retired").inc()
        log.info("lifecycle: compacted slab %s/%s/%s (%d survivors, "
                 "%d blocks released)", vol, bkt, sid, len(survivors),
                 len(txs))

    def _read_slab_range(self, srow: dict, offset: int,
                         length: int) -> np.ndarray:
        """Ranged read out of a slab's EC groups (bulk QoS): the same
        group-walk the client read path does, against the slab row's
        own block directory."""
        from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
        from ozone_tpu_torch.client.ec_writer import BlockGroup

        parts = []
        pos = 0
        for gj in srow["block_groups"]:
            g = BlockGroup.from_json(gj)
            a, b = max(offset, pos), min(offset + length, pos + g.length)
            if a < b:
                reader = ECBlockGroupReader(
                    g, g.pipeline.replication.ec, self.clients(),
                    device=self.device, qos_class="bulk")
                parts.append(reader.read(a - pos, b - a))
            pos += g.length
        out = (np.concatenate(parts) if parts
               else np.zeros(0, np.uint8))
        if out.size != length:
            raise StorageError(
                "IO_EXCEPTION",
                f"slab range [{offset},{offset + length}) short read")
        return out

    @staticmethod
    def _stats_row(stats: dict, now: float) -> dict:
        return {
            "keys_scanned": stats["keys_scanned"],
            "transitioned": stats["transitioned"],
            "expired": stats["expired"],
            "bytes": stats["bytes"],
            "updated": round(now, 3),
        }
