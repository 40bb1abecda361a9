"""ReplicationShipper: the term-fenced replayer that tails the journal.

Port of `ozone_tpu/replication_geo/shipper.py`. A leader-singleton loop
(modeled on `lifecycle/service.py`) tails the OM store's update journal
(`store.get_updates_since`), keeps the key commits and deletes of
buckets that carry replication rules, and replays each affected key's
current source state to the remote cluster through the client datapath.

Exactly-once in effect across a crash of the shipper's leader:

1. **Term fencing**: every cursor checkpoint carries its term, and the
   deterministic apply (`om/requests.GeoCheckpoint`) refuses one whose
   term is not the fenced one, so a deposed shipper never regresses the
   cursor.
2. **Ship, then checkpoint**: the cursor is committed only after the
   page it covers replayed and was acknowledged at the destination; a
   crash between the two re-ships at most one page.
3. **Idempotent replay**: every shipped key carries the source row's
   object id in its destination metadata (`geo-src-oid`); a re-applied
   page sees the marker and skips, and deletes are fenced on the
   observed destination object id.

Conflicts are last-writer-wins: a replay commits under the rewrite fence
(`expect_object_id` of the destination version it supersedes) and loses
with KEY_MODIFIED when the destination moved, or is skipped when the
destination row is newer than the source commit. When the destination
row did not exist at the replay's lookup, the commit is unfenced (the
fence says "expect this version", not "expect absent"), so a
destination-local create inside that window resolves to the replay.

The codec runs on `device`: the source reads (a degraded one decodes)
and the destination's EC writes (a scheme-converting rule re-encodes)
both submit to the codec service at the bulk class, so shipping never
starves interactive work. The shipper takes its device from the caller
(the metadata daemon's, or the OM's): it never falls back to a default.

One departure from the reference, on purpose: the store's txids restart
at 0 when its process restarts, so a durable cursor past the journal's
head comes from before a restart and names no position in this journal.
The reference reads it as "nothing pending" and skips every commit
below it; the port treats it as a journal gap and reconciles every ruled
bucket (`_cursor_is_stale`).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import bucket_key
from ozone_tpu_torch.replication_geo.rules import (
    ReplicationRule,
    first_match,
)
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.metrics import registry

log = logging.getLogger(__name__)

METRICS = registry("replication")

#: default per-ship-cycle wall-clock budget (seconds);
#: OZONE_TPU_GEO_DEADLINE_S overrides, 0 = unbounded
DEFAULT_SHIP_DEADLINE_S = 30.0

#: destination-key metadata carrying the replicated source version: the
#: idempotence marker and the bidirectional echo suppressor
GEO_META_OID = "geo-src-oid"
GEO_META_MTIME = "geo-src-mtime"
#: and the source bucket (/volume/bucket) that shipped it: it scopes
#: tombstone replays and the reconcile's retirement, so fan-in (many
#: source buckets into one destination bucket) never retires a replica
#: another source shipped. Two clusters fanning in from buckets of the
#: same name still collide on it: give them distinct destinations.
GEO_META_SRC = "geo-src"

_OM_ERRORS = (rq.OMError, StorageError)


class GeoFenced(Exception):
    """This shipper's term was fenced out by a newer leader."""


# ---------------------------------------------------- cluster resolution
_inproc: dict[str, Callable[[], object]] = {}
_inproc_lock = threading.Lock()


def register_inprocess(endpoint: str, client_fn: Callable[[], object]):
    """Register an in-process destination (tests / embedded clusters):
    `client_fn()` returns an OzoneClient for `endpoint`."""
    with _inproc_lock:
        _inproc[endpoint] = client_fn


def unregister_inprocess(endpoint: str) -> None:
    with _inproc_lock:
        _inproc.pop(endpoint, None)


class RemoteCluster:
    """Destination-cluster handle: an OzoneClient whose EC writes ride
    the codec service's bulk class (geo traffic must never starve
    interactive work on the card)."""

    def __init__(self, endpoint: str, oz, owned: bool = True):
        self.endpoint = endpoint
        self.oz = oz
        #: whether close() may tear down oz.om — False for in-process
        #: destinations, whose OzoneManager belongs to its own cluster
        self.owned = owned
        #: (volume, bucket) pairs already ensured to exist
        self._ensured: set[tuple[str, str]] = set()

    def ensure_bucket(self, volume: str, bucket: str,
                      replication: str) -> None:
        if (volume, bucket) in self._ensured:
            return
        try:
            self.oz.om.create_volume(volume)
        except _OM_ERRORS as e:
            if getattr(e, "code", "") != rq.VOLUME_ALREADY_EXISTS:
                raise
        try:
            self.oz.om.create_bucket(volume, bucket, replication)
        except _OM_ERRORS as e:
            if getattr(e, "code", "") != rq.BUCKET_ALREADY_EXISTS:
                raise
        # a pre-existing FSO destination cannot serve the replay (the
        # tombstones need the fenced flat-key DeleteKey): refused at
        # first contact instead of stalling on the first tombstone
        info = self.oz.om.bucket_info(volume, bucket)
        if info.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            raise StorageError(
                rq.INVALID_REQUEST,
                f"geo destination /{volume}/{bucket} at {self.endpoint} "
                "is FILE_SYSTEM_OPTIMIZED; replication needs an "
                "OBS/LEGACY destination bucket")
        self._ensured.add((volume, bucket))

    def close(self) -> None:
        if not self.owned:
            return
        close = getattr(self.oz.om, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                log.debug("geo: closing remote %s failed", self.endpoint,
                          exc_info=True)
        self.oz.clients.close()


def resolve_cluster(endpoint: str, tls=None, device="cuda") -> RemoteCluster:
    """Destination handle for a rule endpoint: an in-process registrant
    when one exists (tests, embedded pairs), else a dial of the remote OM
    (an HA list) over the port's RPC, with the SCM's address book for the
    datanodes, as the CLI's clients do. Its EC writes encode on
    `device`."""
    from ozone_tpu_torch.client.ozone_client import OzoneClient

    with _inproc_lock:
        fn = _inproc.get(endpoint)
    if fn is not None:
        base = fn()
        return RemoteCluster(endpoint, OzoneClient(
            base.om, base.clients, device=device,
            ratis_clients=base.ratis_clients, qos_class="bulk"),
            owned=False)
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    clients = DatanodeClientFactory()
    clients.tls = tls
    om = RemoteOmClient(endpoint, clients=clients, tls=tls)
    scm = RemoteScmClient(endpoint, tls=tls)
    try:
        for dn_id, addr in scm.node_addresses().items():
            clients.register_remote(dn_id, addr)
    except StorageError:
        log.warning("geo: SCM at %s unreachable; datanode addresses "
                    "will be learned from allocations", endpoint)
    finally:
        scm.close()
    return RemoteCluster(endpoint, OzoneClient(om, clients, device=device,
                                               qos_class="bulk"))


# ------------------------------------------------------------- shipper
class ReplicationShipper:
    """Per-bucket asynchronous cross-cluster replication.

    ``term_fn`` returns the fencing term (the metadata ring's raft term
    under HA; 0 standalone). ``leader_fn`` gates each cycle: only the
    ring leader ships. ``clients_fn`` resolves the source datanode
    client factory lazily (daemons learn addresses from heartbeats).
    ``resolver`` maps a rule endpoint to a RemoteCluster (defaults to
    resolve_cluster over ``tls``). ``device`` is where the source reads
    decode and the destination writes encode."""

    STATE_KEY = "geo_state"

    def __init__(self, om, clients=None, clients_fn=None,
                 term_fn: Optional[Callable[[], int]] = None,
                 leader_fn: Optional[Callable[[], bool]] = None,
                 resolver: Optional[Callable[[str], RemoteCluster]] = None,
                 throttle=None, page: int = 64,
                 ship_deadline_s: Optional[float] = None, tls=None,
                 device="cuda"):
        self.om = om
        self.device = device
        self._clients = clients
        self._clients_fn = clients_fn
        self.term_fn = term_fn or (lambda: 0)
        self.leader_fn = leader_fn or (lambda: True)
        self.throttle = throttle
        self.page = page
        self.tls = tls
        self.resolver = resolver or (
            lambda ep: resolve_cluster(ep, tls=self.tls,
                                       device=self.device))
        if ship_deadline_s is None:
            from ozone_tpu_torch.utils.config import env_float

            ship_deadline_s = env_float("OZONE_TPU_GEO_DEADLINE_S",
                                        DEFAULT_SHIP_DEADLINE_S)
        self.ship_deadline_s = ship_deadline_s
        self._fenced_term: Optional[int] = None
        self._remotes: dict[str, RemoteCluster] = {}
        # one cycle at a time per service (run-now racing the daemon
        # cadence would interleave same-term cursor checkpoints)
        self._ship_lock = threading.Lock()
        #: wall time the current non-zero lag was first observed (the
        #: seconds-behind fallback when pending deletes carry no mtime)
        self._lag_since: Optional[float] = None

    # ------------------------------------------------------------ plumbing
    def clients(self):
        if self._clients_fn is not None:
            return self._clients_fn()
        return self._clients

    def source_client(self):
        from ozone_tpu_torch.client.ozone_client import OzoneClient

        # the bulk class on the source side too: shipping a large EC
        # bucket must not flood the codec service's decode queue at
        # interactive priority
        return OzoneClient(self.om, self.clients(), device=self.device,
                           qos_class="bulk")

    def state(self) -> dict:
        return self.om.store.get("system", self.STATE_KEY) or {}

    def remote(self, endpoint: str) -> RemoteCluster:
        r = self._remotes.get(endpoint)
        if r is None:
            r = self._remotes[endpoint] = self.resolver(endpoint)
        return r

    def close(self) -> None:
        for r in self._remotes.values():
            r.close()
        self._remotes.clear()

    def _checkpoint(self, term: int, cursor: dict,
                    stats: Optional[dict] = None,
                    bootstrapped: Optional[list] = None,
                    fence: bool = False) -> None:
        try:
            self.om.submit(rq.GeoCheckpoint(
                term=term, cursor=cursor, stats=stats or {},
                bootstrapped=bootstrapped, fence=fence))
        except rq.OMError as e:
            if e.code == rq.GEO_FENCED:
                METRICS.counter("leader_fences").inc()
                raise GeoFenced(str(e))
            raise

    def _fence(self, term: int) -> None:
        """Claim the shipper role for this term (idempotent per term):
        after this commits, checkpoints from any OLDER term are
        deterministically rejected on every replica."""
        if self._fenced_term == term:
            return
        self._checkpoint(term, cursor=self.state().get("cursor", {}),
                         fence=True)
        self._fenced_term = term

    def _bucket_rules(self) -> dict[str, tuple[dict, list[ReplicationRule]]]:
        out: dict[str, tuple[dict, list[ReplicationRule]]] = {}
        for bk, brow in self.om.store.iterate("buckets"):
            raw = brow.get("geo_replication") or []
            if not raw:
                continue
            try:
                rules = [ReplicationRule.from_json(d) for d in raw]
            except ValueError as e:
                log.warning("geo: bucket %s has invalid replication "
                            "rules (%s); skipping", bk, e)
                continue
            out[bk] = (brow, rules)
        return out

    # ---------------------------------------------------------------- lag
    def lag(self, buckets: Optional[dict] = None) -> dict:
        """WAL-head lag: journal entries between the shipped cursor and
        the head, plus a seconds-behind estimate (oldest pending
        matching commit's mtime; wall-clock since lag appeared when only
        tombstones are pending). Updates the replication.* gauges.
        `buckets` lets the ship cycle reuse its own rule scan."""
        state = self.state()
        txid = int((state.get("cursor") or {}).get("txid", 0))
        updates, head, _complete = self.om.store.get_updates_since(txid)
        if self._cursor_is_stale(txid, head):
            # everything journaled since the restart is pending
            updates, head, _complete = self.om.store.get_updates_since(0)
        if buckets is None:
            buckets = self._bucket_rules()
        entries = 0
        oldest: Optional[float] = None
        for _utx, table, key, value in updates:
            if table != "keys":
                continue
            bk = self._bucket_of(key)
            if bk not in buckets:
                continue
            entries += 1
            if value is not None:
                ts = float(value.get("modified")
                           or value.get("created") or 0.0)
                if ts and (oldest is None or ts < oldest):
                    oldest = ts
        now = time.time()
        if entries:
            if self._lag_since is None:
                self._lag_since = now
            seconds = (now - oldest if oldest is not None
                       else now - self._lag_since)
        else:
            self._lag_since = None
            seconds = 0.0
        seconds = max(0.0, seconds)
        METRICS.gauge("lag_entries").set(entries)
        METRICS.gauge("lag_seconds").set(round(seconds, 3))
        return {"entries": entries, "seconds": round(seconds, 3),
                "head_txid": head, "cursor_txid": txid}

    @staticmethod
    def _cursor_is_stale(txid: int, head: int) -> bool:
        """A cursor past the journal's head was written before the
        store's process restarted (txids restart at 0 with it)."""
        return txid > head

    @staticmethod
    def _bucket_of(store_key: str) -> str:
        """/vol/bucket/key... -> /vol/bucket (snapshot rows excluded)."""
        if store_key.startswith("/.snap"):
            return ""
        parts = store_key.split("/", 3)
        return f"/{parts[1]}/{parts[2]}" if len(parts) >= 4 else ""

    # --------------------------------------------------------------- cycle
    def run_once(self, max_entries: Optional[int] = None) -> dict:
        """One ship cycle: bootstrap newly-ruled buckets, then tail the
        WAL delta from the replicated cursor and replay affected keys.
        Safe to call on any node — followers return
        {"skipped": "not_leader"}. `max_entries` bounds the WAL scan
        (tests / incremental ticks)."""
        if not self.leader_fn():
            return {"skipped": "not_leader"}
        if not self._ship_lock.acquire(blocking=False):
            return {"skipped": "ship_in_progress"}
        try:
            return self._run_once_locked(max_entries)
        finally:
            self._ship_lock.release()

    def _run_once_locked(self, max_entries: Optional[int]) -> dict:
        term = int(self.term_fn())
        stats = {"entries_scanned": 0, "keys_shipped": 0,
                 "deletes_shipped": 0, "conflicts": 0, "in_sync": 0,
                 "skipped": 0, "failed": 0, "bytes": 0, "pages": 0,
                 "bootstrapped": 0, "complete": False}
        t0 = time.monotonic()
        buckets = self._bucket_rules()
        if not buckets:
            # no bucket carries rules: nothing to fence, tail or
            # checkpoint — a rule-less cluster must see ZERO geo ring
            # traffic (no WAL self-churn, no background ring commits)
            stats["complete"] = True
            METRICS.gauge("lag_entries").set(0)
            METRICS.gauge("lag_seconds").set(0.0)
            return stats
        try:
            with resilience.start("geo_ship",
                                  seconds=self.ship_deadline_s):
                self._fence(term)
                self._ship(term, buckets, stats, max_entries)
        except GeoFenced:
            stats["fenced"] = True
            log.info("geo: shipper fenced out (term %d)", term)
        except StorageError as e:
            if e.code != resilience.DEADLINE_EXCEEDED:
                raise
            # budget spent mid-cycle: everything checkpointed so far is
            # durable; the un-checkpointed tail re-ships next cycle
            stats["deadline_exceeded"] = True
        METRICS.timer("ship_seconds").update(time.monotonic() - t0)
        METRICS.counter("cycles").inc()
        self.lag(buckets=buckets)
        return stats

    def _ship(self, term: int, buckets: dict, stats: dict,
              max_entries: Optional[int]) -> None:
        state = self.state()
        cursor = dict(state.get("cursor") or {})
        txid = int(cursor.get("txid", 0))
        # bootstrap: full reconcile of buckets whose rules predate their
        # WAL coverage (rule installed after the journal rolled, or a
        # brand-new rule over an existing namespace). Entries journaled
        # DURING the reconcile re-ship via the delta path — harmless,
        # the geo-src-oid marker makes the second pass a no-op.
        boot = set(state.get("bootstrapped") or []) & set(buckets)
        for bk in sorted(set(buckets) - boot):
            brow, rules = buckets[bk]
            self._reconcile_bucket(bk, brow, rules, stats)
            boot.add(bk)
            stats["bootstrapped"] += 1
            METRICS.counter("bootstraps").inc()
            self._checkpoint(term, cursor={"txid": txid},
                             bootstrapped=sorted(boot),
                             stats=self._stats_row(stats))
        updates, head, complete = self.om.store.get_updates_since(txid)
        if not complete or self._cursor_is_stale(txid, head):
            # the journal rolled past the cursor (the leader was down too
            # long), or the cursor predates the store's restart: the
            # delta is gone, so reconcile every ruled bucket, then resume
            # tailing from the current head
            METRICS.counter("journal_gaps").inc()
            stats["journal_gap"] = True
            for bk in sorted(buckets):
                brow, rules = buckets[bk]
                self._reconcile_bucket(bk, brow, rules, stats)
            self._checkpoint(term, cursor={"txid": head},
                             bootstrapped=sorted(boot),
                             stats=self._stats_row(stats))
            stats["complete"] = True
            return
        truncated = False
        if max_entries is not None and len(updates) > max_entries:
            truncated = True  # a bounded tick: report complete=False
            updates = updates[:max_entries]
        # page the tail: per page, coalesce entries by key (the replay
        # ships the CURRENT source state, so N entries of one key cost
        # one replay) — ship, then checkpoint the covered txid
        i = 0
        while i < len(updates):
            resilience.check_deadline("geo_page")
            page_keys: dict[tuple[str, str], None] = {}
            last_txid = txid
            while i < len(updates) and len(page_keys) < self.page:
                utx, table, key, _value = updates[i]
                i += 1
                last_txid = utx
                stats["entries_scanned"] += 1
                if table != "keys":
                    continue
                bk = self._bucket_of(key)
                if bk not in buckets:
                    continue
                page_keys.setdefault((bk, key.split("/", 3)[3]), None)
            for bk, name in page_keys:
                brow, rules = buckets[bk]
                self._replay_key(brow, rules, name, stats)
            self._checkpoint(term, cursor={"txid": last_txid},
                             bootstrapped=sorted(boot),
                             stats=self._stats_row(stats))
            stats["pages"] += 1
            METRICS.counter("pages_shipped").inc()
            txid = last_txid
        stats["complete"] = not truncated

    @staticmethod
    def _stats_row(stats: dict) -> dict:
        """The durable per-cycle summary riding each checkpoint (the
        `replication status` / Recon "last cycle" view)."""
        return {
            "entries_scanned": stats["entries_scanned"],
            "keys_shipped": stats["keys_shipped"],
            "deletes_shipped": stats["deletes_shipped"],
            "conflicts": stats["conflicts"],
            "failed": stats["failed"],
            "bytes": stats["bytes"],
            "updated": round(time.time(), 3),
        }

    # ----------------------------------------------------------- reconcile
    def _reconcile_bucket(self, bk: str, brow: dict,
                          rules: list[ReplicationRule],
                          stats: dict) -> None:
        """Anti-entropy pass over one bucket: ship every matching source
        key, then delete destination replicas (ours, by marker) whose
        source key is gone. Idempotent — safe to re-run after a crash
        mid-pass."""
        volume, bucket = brow["volume"], brow["name"]
        live: set[tuple[str, str, str, str]] = set()
        for info in self.om.list_keys(volume, bucket):
            resilience.check_deadline("geo_reconcile")
            name = info["name"]
            rule = first_match(rules, name)
            if rule is None:
                continue
            self._replay_key(brow, rules, name, stats)
            live.add((rule.endpoint, rule.volume or volume,
                      rule.bucket or bucket, name))
        # retire OUR stale replicas at each destination (a source key
        # deleted while the journal was gone leaves no tombstone to
        # replay; the marker scopes the sweep to keys we shipped)
        for rule in rules:
            if not rule.enabled:
                continue
            dvol = rule.volume or volume
            dbkt = rule.bucket or bucket
            remote = self.remote(rule.endpoint)
            try:
                dkeys = remote.oz.om.list_keys(dvol, dbkt, rule.prefix)
            except _OM_ERRORS as e:
                code = getattr(e, "code", "")
                if code not in (rq.BUCKET_NOT_FOUND,
                                rq.VOLUME_NOT_FOUND):
                    raise
                continue  # destination bucket not created yet
            for dinfo in dkeys:
                meta = dinfo.get("metadata") or {}
                if meta.get(GEO_META_SRC) != bk:
                    # locally-written destination key, or a replica
                    # ANOTHER source bucket/cluster shipped into this
                    # shared destination — never ours to retire
                    continue
                if (rule.endpoint, dvol, dbkt, dinfo["name"]) in live:
                    continue
                self._delete_at(remote, dvol, dbkt, dinfo["name"],
                                dinfo, stats)

    # -------------------------------------------------------------- replay
    def _replay_key(self, brow: dict, rules: list[ReplicationRule],
                    name: str, stats: dict) -> None:
        """Replay one source key's current state to its rule's
        destination, retrying transient failures under the ambient
        deadline. A key that still fails after the retries aborts the
        cycle WITHOUT checkpointing its page (at-least-once: the page
        re-ships next cycle instead of silently skipping the key)."""
        rule = first_match(rules, name)
        if rule is None:
            stats["skipped"] += 1
            return
        policy = resilience.RetryPolicy(max_attempts=3)
        attempt = 0
        while True:
            try:
                self._replay_once(brow, rule, name, stats)
                return
            except _OM_ERRORS as e:
                if getattr(e, "code", "") == resilience.DEADLINE_EXCEEDED:
                    raise
                log.warning("geo: replay of %s/%s/%s -> %s failed "
                            "(attempt %d): %s", brow["volume"],
                            brow["name"], name, rule.endpoint,
                            attempt + 1, e)
                if not policy.sleep(attempt):
                    stats["failed"] += 1
                    METRICS.counter("ship_failures").inc()
                    raise
                attempt += 1

    def _replay_once(self, brow: dict, rule: ReplicationRule,
                     name: str, stats: dict) -> None:
        volume, bucket = brow["volume"], brow["name"]
        dvol = rule.volume or volume
        dbkt = rule.bucket or bucket
        remote = self.remote(rule.endpoint)
        try:
            info = self.om.lookup_key(volume, bucket, name)
        except rq.OMError as e:
            if e.code != rq.KEY_NOT_FOUND:
                raise
            self._replay_delete(remote, dvol, dbkt, name,
                                bucket_key(volume, bucket), stats)
            return
        remote.ensure_bucket(dvol, dbkt,
                             rule.scheme or brow.get("replication")
                             or str(info.get("replication", "")))
        src_oid = str(info.get("object_id", ""))
        src_ts = float(info.get("modified") or info.get("created") or 0.0)
        dinfo = self._dest_lookup(remote, dvol, dbkt, name)
        fence_oid = ""
        if dinfo is not None:
            dmeta = dinfo.get("metadata") or {}
            if dmeta.get(GEO_META_OID) == src_oid:
                stats["in_sync"] += 1  # this exact version already landed
                return
            src_meta = info.get("metadata") or {}
            if src_meta.get(GEO_META_OID) == str(dinfo.get("object_id")):
                stats["in_sync"] += 1  # bidirectional echo: source row IS
                return                 # a replica of the destination row
            dest_ts = float(dinfo.get("modified")
                            or dinfo.get("created") or 0.0)
            if GEO_META_OID not in dmeta and dest_ts > src_ts:
                # last-writer-wins: a destination-side overwrite newer
                # than this source commit is authoritative
                stats["conflicts"] += 1
                METRICS.counter("conflicts").inc()
                return
            fence_oid = str(dinfo.get("object_id", ""))
        src = self.source_client()
        from ozone_tpu_torch.client.ozone_client import OzoneBucket

        data = OzoneBucket(src, volume, bucket).read_key_info(info)
        if self.throttle is not None and data.size:
            self.throttle.take(int(data.size))
        meta = dict(info.get("metadata") or {})
        meta[GEO_META_OID] = src_oid
        meta[GEO_META_MTIME] = repr(src_ts)
        meta[GEO_META_SRC] = bucket_key(volume, bucket)
        scheme = rule.scheme or str(info.get("replication", "")) or None
        dbucket = OzoneBucket(remote.oz, dvol, dbkt)
        h = dbucket.open_key(name, scheme, metadata=meta)
        # rewrite fence: commit only if the destination row is still the
        # version this replay observed — a concurrent destination-side
        # overwrite wins with KEY_MODIFIED (last-writer-wins)
        h._session.expect_object_id = fence_oid
        try:
            h.write(data)
            h.close()
        except _OM_ERRORS as e:
            if getattr(e, "code", "") == rq.KEY_MODIFIED:
                stats["conflicts"] += 1
                METRICS.counter("conflicts").inc()
                return
            raise
        stats["keys_shipped"] += 1
        stats["bytes"] += int(data.size)
        METRICS.counter("keys_shipped").inc()
        METRICS.counter("bytes_shipped").inc(int(data.size))

    def _dest_lookup(self, remote: RemoteCluster, dvol: str, dbkt: str,
                     name: str) -> Optional[dict]:
        try:
            return remote.oz.om.lookup_key(dvol, dbkt, name)
        except _OM_ERRORS as e:
            code = getattr(e, "code", "")
            if code in (rq.KEY_NOT_FOUND, rq.BUCKET_NOT_FOUND,
                        rq.VOLUME_NOT_FOUND):
                return None
            raise

    def _replay_delete(self, remote: RemoteCluster, dvol: str, dbkt: str,
                       name: str, src: str, stats: dict) -> None:
        dinfo = self._dest_lookup(remote, dvol, dbkt, name)
        if dinfo is None:
            stats["in_sync"] += 1  # already gone (or never shipped)
            return
        meta = dinfo.get("metadata") or {}
        if meta.get(GEO_META_SRC) != src:
            # the destination row was written locally at the
            # destination — or shipped there by a DIFFERENT source
            # fanning into the same bucket — never by us: it wins
            # (deleting it would destroy data we do not own)
            stats["conflicts"] += 1
            METRICS.counter("conflicts").inc()
            return
        self._delete_at(remote, dvol, dbkt, name, dinfo, stats)

    def _delete_at(self, remote: RemoteCluster, dvol: str, dbkt: str,
                   name: str, dinfo: dict, stats: dict) -> None:
        try:
            remote.oz.om.delete_key(
                dvol, dbkt, name,
                expect_object_id=str(dinfo.get("object_id", "")))
        except _OM_ERRORS as e:
            code = getattr(e, "code", "")
            if code == rq.KEY_MODIFIED:
                # overwritten at the destination between our lookup and
                # the fenced delete: the overwrite wins
                stats["conflicts"] += 1
                METRICS.counter("conflicts").inc()
                return
            if code == rq.KEY_NOT_FOUND:
                return  # a concurrent replay already retired it
            raise
        stats["deletes_shipped"] += 1
        METRICS.counter("deletes_shipped").inc()
