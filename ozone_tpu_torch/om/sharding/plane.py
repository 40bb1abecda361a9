"""In-process sharded metadata plane: N shard rings under a root map.

Port of `ozone_tpu/om/sharding/plane.py`. Two modes:

- ``mode="plain"``: each shard is one OzoneManager over its own store
  (no raft), all sharing the caller's SCM and datanode clients. This is
  the shard-scaling shape (independent stores mean independent sqlite
  commits) and the crash-recovery drill shape (a coordinator crash
  leaves exactly the journal and intent rows a dead process would).
- ``mode="ring"``: each shard is a `replicas`-node MetaHARing over an
  InProcessTransport: the kill-the-leader drill shape and the
  follower-read shape (every replica holds a read lease off the
  leader's heartbeats).

The root ring is the degenerate single-replica form here: one
OzoneManager store holding the shard map and the 2PC coordinator
journal.

`ShardedOm` is the facade the rest of the stack talks to: it has the
OzoneManager surface (`OzoneClient(facade, clients)` and freon work
unchanged), routes every (volume, bucket) op to the owning shard through
the cached shard map, retries once through a map refresh on
`SHARD_MOVED`, resolves bucket-link chains across shards (a per-shard OM
can only follow local links), fans volume ops out to every shard, and
drives cross-bucket renames and cross-shard links through the 2PC
coordinator. Every verb it does not route goes to shard 0's leader, as
in the reference; on a bucket another shard owns, such a verb answers
SHARD_MOVED from the ownership gate.

Every OzoneManager the plane builds takes its `device`, and `client()`
gives an OzoneClient that encodes and decodes there; the plane resolves
the device when it is built, so "cuda" raises without CUDA.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Optional

from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.consensus.meta_ring import MetaHARing
from ozone_tpu_torch.consensus.raft import (
    InProcessTransport,
    NotRaftLeaderError,
)
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import bucket_key
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.om.sharding.shardmap import (
    SHARD_MOVED,
    SLOT_COUNT,
    ImportRow,
    InstallShardConfig,
    InstallShardMap,
    ShardMap,
    slot_for,
)
from ozone_tpu_torch.om.sharding.txn import CrossShardCoordinator
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.utils.metrics import registry

METRICS = registry("om.shard")

#: tables copied when a slot migrates between shards (key-bearing
#: tables are prefix-scanned per bucket; FSO tables ride the same
#: bucket_key prefix scheme). `dir_ids` and `prefixes` are left out, as
#: in the reference.
_MIGRATE_TABLES = ("buckets", "keys", "open_keys", "deleted_keys",
                   "multipart", "dirs", "files", "deleted_dirs",
                   "slabs")


def _meta_scm() -> StorageContainerManager:
    """A liveness-quiet SCM for metadata-only shard replicas (no
    datanodes register with it; block ops use the shared data SCM)."""
    return StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6)


class _Shard:
    """One shard: a plain OzoneManager or a ring of replicas."""

    def __init__(self, shard_id: str, base: Path, mode: str,
                 scm=None, clients=None, replicas: int = 3,
                 timers: bool = True, push_commit: bool = False,
                 device="cuda"):
        self.id = shard_id
        self.mode = mode
        self.replicas: list[MetaHARing] = []
        #: highest applied index this plane has observed on the shard's
        #: leader after a write: the facade's read-your-writes floor
        self.applied_floor = 0
        if mode == "plain":
            self.plain_om = OzoneManager(base / "om.db", scm or _meta_scm(),
                                         clients=clients, device=device)
            self.transport = None
            return
        self.plain_om = None
        self.transport = InProcessTransport()
        self._timers = timers
        ids = [f"{shard_id}-r{i}" for i in range(replicas)]
        for nid in ids:
            rep_scm = _meta_scm()
            rep_om = OzoneManager(base / nid / "om.db", rep_scm,
                                  clients=clients, device=device)
            ring = MetaHARing(rep_om, rep_scm, base / nid / "raft",
                              nid, ids, transport=self.transport)
            # a fresh commit index on every write: follower leases serve
            # reads within min_applied at once, not a heartbeat late.
            # Only with follower reads on: for write-only rings the
            # extra replication round is pure overhead
            ring.push_commit_on_write = push_commit
            # writes reaching this replica's OM go through the ring (the
            # daemon's HA patch, in-process form)
            rep_om.submit = ring.submit_om
            self.replicas.append(ring)
        if timers:
            for r in self.replicas:
                r.node.start_timers()
        else:
            self.replicas[0].node.start_election()

    # -- leadership ----------------------------------------------------
    def leader(self) -> Optional[MetaHARing]:
        for r in self.replicas:
            # a killed leader keeps its LEADER role (a dead process
            # cannot demote itself): the transport's down set is truth
            if r.node.node_id in self.transport.down:
                continue
            if r.is_ready:
                return r
        return None

    def await_leader(self, timeout: float = 5.0) -> MetaHARing:
        deadline = time.monotonic() + timeout
        while True:
            r = self.leader()
            if r is not None:
                return r
            if time.monotonic() >= deadline:
                raise TimeoutError(f"shard {self.id}: no ready leader")
            if not self._timers:
                for cand in self.replicas:
                    if cand.node.node_id not in self.transport.down:
                        cand.node.start_election()
            time.sleep(0.01)  # ozlint: allow[deadline-propagation] -- in-process ring's election poll, bounded by the caller's own deadline check above

    @property
    def om(self) -> OzoneManager:
        """The authoritative (leader) OM of this shard."""
        if self.mode == "plain":
            return self.plain_om
        return self.await_leader().om

    def on_leader(self, fn: Callable[[OzoneManager], Any],
                  floor: bool = False) -> Any:
        """fn(the leader's OM); on a leader deposed between the lookup and
        the write, again on the new one (three tries). With `floor` the
        applied index the write reached becomes the read floor."""
        if self.mode == "plain":
            return fn(self.plain_om)
        err: Exception = TimeoutError(f"shard {self.id} unavailable")
        for _ in range(3):
            try:
                ring = self.await_leader()
                result = fn(ring.om)
                if floor:
                    self.applied_floor = ring.node.last_applied
                return result
            except NotRaftLeaderError as e:
                err = e  # deposed between await and submit: re-resolve
        raise err

    def submit(self, request: rq.OMRequest) -> Any:
        return self.on_leader(lambda om: om.submit(request), floor=True)

    # -- failure injection --------------------------------------------
    def kill_leader(self) -> str:
        """kill -9 the shard leader: its node stops mid-flight and the
        transport drops it, exactly as a dead process looks to peers."""
        ring = self.await_leader()
        nid = ring.node.node_id
        self.transport.down.add(nid)
        ring.node.stop()
        return nid

    def close(self) -> None:
        for r in self.replicas:
            r.node.stop()
            r.om.store.close()
        if self.plain_om is not None:
            self.plain_om.store.close()


class ShardedMetaPlane:
    """Boot and operate a sharded metadata plane in one process."""

    def __init__(self, base_dir: Path, n_shards: int = 2,
                 mode: str = "plain", replicas: int = 3,
                 scm=None, clients=None, timers: bool = True,
                 follower_reads: bool = False,
                 slot_count: int = SLOT_COUNT, device="cuda"):
        base = Path(base_dir)
        self.device = resolve_device(device)
        self.mode = mode
        self.follower_reads = follower_reads and mode == "ring"
        # the root ring (degenerate single replica): shard map + journal
        self.root = OzoneManager(base / "root" / "om.db",
                                 scm or _meta_scm(), device=self.device)
        self.shard_ids = [f"s{i}" for i in range(n_shards)]
        self.shards = {
            sid: _Shard(sid, base / sid, mode, scm=scm, clients=clients,
                        replicas=replicas, timers=timers,
                        push_commit=self.follower_reads,
                        device=self.device)
            for sid in self.shard_ids
        }
        m = ShardMap.uniform(self.shard_ids, epoch=1,
                             slot_count=slot_count)
        self.install_map(m)
        self.coordinator = CrossShardCoordinator(
            self.root.submit,
            lambda sid, request: self.shards[sid].submit(request),
            self.root.store,
            self.current_map,
        )
        self.facade = ShardedOm(self)

    # -- shard map -----------------------------------------------------
    def current_map(self) -> ShardMap:
        row = self.root.store.get("system", "shard_map")
        return ShardMap.from_json(row)

    def install_map(self, m: ShardMap) -> None:
        """Publish a map epoch: the per-shard replicated ownership
        configs first (enforcement), then the root row (discovery)."""
        for sid in m.shards:
            self.shards[sid].submit(InstallShardConfig(
                epoch=m.epoch, shard_id=sid,
                slot_count=m.slot_count, owned=m.owned_slots(sid)))
        self.root.submit(InstallShardMap(m.to_json()))

    def migrate_slot(self, slot: int, to_shard: str) -> ShardMap:
        """Rebalance one slot (docs/OPERATIONS.md runbook): fence the
        source (it starts rejecting the slot with SHARD_MOVED), copy the
        slot's rows, grant the target, publish the bumped map. Requests
        racing the window bounce off both sides and retry through the
        refreshed map."""
        m = self.current_map()
        from_shard = m.shards[m.slots[slot]]
        if from_shard == to_shard:
            return m
        new_map = m.move_slot(slot, to_shard)
        src, dst = self.shards[from_shard], self.shards[to_shard]
        src.submit(InstallShardConfig(
            epoch=new_map.epoch, shard_id=from_shard,
            slot_count=new_map.slot_count,
            owned=new_map.owned_slots(from_shard)))
        self._copy_slot_rows(slot, src.om.store, dst)
        dst.submit(InstallShardConfig(
            epoch=new_map.epoch, shard_id=to_shard,
            slot_count=new_map.slot_count,
            owned=new_map.owned_slots(to_shard)))
        self.root.submit(InstallShardMap(new_map.to_json()))
        METRICS.counter("slots_migrated").inc()
        return new_map

    def _copy_slot_rows(self, slot: int, src_store, dst: _Shard) -> None:
        # volumes exist on every shard already (fan-out create); move
        # the slot's bucket-scoped rows through replicated raw imports
        for vk, _ in list(src_store.iterate("volumes")):
            for bk, brow in list(src_store.iterate("buckets", vk + "/")):
                vol, bkt = brow["volume"], brow["name"]
                if slot_for(vol, bkt, self.current_map().slot_count) \
                        != slot:
                    continue
                dst.submit(ImportRow("buckets", bk, brow))
                for table in _MIGRATE_TABLES[1:]:
                    prefix = bucket_key(vol, bkt) + "/"
                    for k, row in list(src_store.iterate(table, prefix)):
                        dst.submit(ImportRow(table, k, row))

    def recover(self) -> list[dict]:
        """Re-drive open cross-shard transactions after a crash."""
        return self.coordinator.recover()

    def client(self, clients=None):
        """An OzoneClient over the sharded facade on the plane's device
        (the full data path when `clients` is the data plane's
        DatanodeClientFactory)."""
        from ozone_tpu_torch.client.ozone_client import OzoneClient

        return OzoneClient(self.facade, clients, device=self.device)

    def close(self) -> None:
        for shard in self.shards.values():
            shard.close()
        self.root.store.close()


class ShardedOm:
    """OzoneManager-surface facade routing by the cached shard map."""

    def __init__(self, plane: ShardedMetaPlane):
        self._plane = plane
        self._map = plane.current_map()
        self._rr = 0  # follower round-robin cursor
        self.metrics = METRICS

    # -- plumbing ------------------------------------------------------
    @property
    def block_size(self) -> int:
        return self._shard0.om.block_size

    @property
    def _shard0(self) -> _Shard:
        return self._plane.shards[self._plane.shard_ids[0]]

    def _read_om(self, shard: _Shard, verb: str,
                 min_applied: Optional[int] = None) -> OzoneManager:
        """The replica to serve a read: a lease-holding follower when
        enabled and fresh enough, else the leader."""
        if shard.mode == "ring" and self._plane.follower_reads:
            floor = shard.applied_floor if min_applied is None \
                else min_applied
            n = len(shard.replicas)
            for k in range(n):
                r = shard.replicas[(self._rr + k) % n]
                if r.node.is_leader or \
                        r.node.node_id in shard.transport.down:
                    continue
                if r.read_gate.try_serve(verb, floor):
                    self._rr = (self._rr + k + 1) % n
                    return r.om
        return shard.om

    def _routed(self, verb: str, volume: str, bucket: str,
                fn: Callable[[OzoneManager], Any],
                write: bool = False) -> Any:
        """Route fn to the owning shard; one SHARD_MOVED retry through a
        root-map refresh (the client-side cache invalidation)."""
        for attempt in (0, 1):
            sid = self._map.shard_for(volume, bucket)
            shard = self._plane.shards[sid]
            self.metrics.counter("routes").inc()
            try:
                if write:
                    # the port retries a write whose leader was deposed
                    # under it, as the plane's own submits do; the
                    # reference's facade raises NotRaftLeaderError
                    return shard.on_leader(fn)
                return fn(self._read_om(shard, verb))
            except rq.OMError as e:
                if e.code == SHARD_MOVED and attempt == 0:
                    self.metrics.counter("moved_rejections").inc()
                    self._map = self._plane.current_map()
                    continue
                raise
        raise AssertionError("unreachable")  # pragma: no cover

    # -- volumes (fan-out: every shard owns buckets of any volume) -----
    def create_volume(self, volume: str, owner: str = "root") -> None:
        for sid in self._plane.shard_ids:
            self._plane.shards[sid].submit(rq.CreateVolume(volume, owner))

    def delete_volume(self, volume: str) -> None:
        for sid in self._plane.shard_ids:  # check all, then delete all
            om = self._plane.shards[sid].om
            if om.list_buckets(volume):
                raise rq.OMError(rq.VOLUME_NOT_EMPTY, volume)
        for sid in self._plane.shard_ids:
            self._plane.shards[sid].submit(rq.DeleteVolume(volume))

    def volume_info(self, volume: str) -> dict:
        return self._read_om(self._shard0, "VolumeInfo").volume_info(
            volume)

    def list_volumes(self) -> list[dict]:
        return self._read_om(self._shard0, "ListVolumes").list_volumes()

    # -- buckets -------------------------------------------------------
    def create_bucket(self, volume: str, bucket: str, *a, **kw) -> None:
        self._routed("CreateBucket", volume, bucket,
                     lambda om: om.create_bucket(volume, bucket, *a, **kw),
                     write=True)

    def create_bucket_link(self, src_volume: str, src_bucket: str,
                           volume: str, bucket: str) -> None:
        if self._map.shard_for(src_volume, src_bucket) == \
                self._map.shard_for(volume, bucket):
            self._routed(
                "CreateBucket", volume, bucket,
                lambda om: om.create_bucket_link(
                    src_volume, src_bucket, volume, bucket),
                write=True)
            return
        # the source validated on its shard, the link staged on the
        # link's own shard, both committed under the root journal
        self._plane.coordinator.link_bucket_cross(rq.CreateBucket(
            volume, bucket, created=time.time(),
            source_volume=src_volume, source_bucket=src_bucket))

    def delete_bucket(self, volume: str, bucket: str) -> None:
        self._routed("DeleteBucket", volume, bucket,
                     lambda om: om.delete_bucket(volume, bucket),
                     write=True)

    def bucket_info(self, volume: str, bucket: str) -> dict:
        # a raw-row read and link resolution in the facade: a per-shard
        # OM cannot follow a link whose source lives on another shard
        b = self._routed(
            "BucketInfo", volume, bucket,
            lambda om: om.store.get("buckets", bucket_key(volume, bucket)))
        if b is None:
            raise rq.OMError(rq.BUCKET_NOT_FOUND, f"{volume}/{bucket}")
        if b.get("source"):
            rv, rb = self.resolve_bucket(volume, bucket)
            eff = self._routed(
                "BucketInfo", rv, rb,
                lambda om: om.store.get("buckets",
                                        bucket_key(rv, rb))) or {}
            b = dict(b)
            b["replication"] = eff.get("replication", b["replication"])
            b["layout"] = eff.get("layout", b["layout"])
        return b

    def list_buckets(self, volume: str) -> list[dict]:
        out: list[dict] = []
        for sid in self._plane.shard_ids:
            shard = self._plane.shards[sid]
            om = self._read_om(shard, "ListBuckets")
            out.extend(om.list_buckets(volume))
        return sorted(out, key=lambda b: b["name"])

    def resolve_bucket(self, volume: str, bucket: str) -> tuple[str, str]:
        """Cross-shard link-chain resolution (OzoneManager.resolve_bucket
        semantics, each hop routed to its owner)."""
        seen: set = set()
        while True:
            row = self._routed(
                "BucketInfo", volume, bucket,
                lambda om, v=volume, b=bucket:
                    om.store.get("buckets", bucket_key(v, b)))
            if row is None:
                if seen:
                    raise rq.OMError(rq.DANGLING_LINK,
                                     f"{volume}/{bucket} missing")
                raise rq.OMError(rq.BUCKET_NOT_FOUND,
                                 f"{volume}/{bucket}")
            src = row.get("source")
            if not src:
                return volume, bucket
            if (volume, bucket) in seen:
                raise rq.OMError(rq.DANGLING_LINK,
                                 f"link loop at {volume}/{bucket}")
            seen.add((volume, bucket))
            volume, bucket = src["volume"], src["bucket"]

    # -- keys ----------------------------------------------------------
    def open_key(self, volume: str, bucket: str, key: str, *a, **kw):
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "OpenKey", rv, rb,
            lambda om: om.open_key(rv, rb, key, *a, **kw), write=True)

    def allocate_block(self, session, *a, **kw):
        return self._routed(
            "AllocateBlock", session.volume, session.bucket,
            lambda om: om.allocate_block(session, *a, **kw), write=True)

    def commit_key(self, session, groups, size, hsync: bool = False):
        return self._routed(
            "CommitKey", session.volume, session.bucket,
            lambda om: om.commit_key(session, groups, size, hsync),
            write=True)

    def lookup_key(self, volume: str, bucket: str, key: str) -> dict:
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed("LookupKey", rv, rb,
                            lambda om: om.lookup_key(rv, rb, key))

    # small-object verbs: slabs are bucket-scoped rows, so a batched
    # CommitKeys (N needles and the slab directory) lands on exactly one
    # shard ring as one entry
    def set_bucket_smallobj(self, volume: str, bucket: str, *a, **kw):
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "SetBucketSmallObj", rv, rb,
            lambda om: om.set_bucket_smallobj(rv, rb, *a, **kw),
            write=True)

    def put_inline_key(self, volume: str, bucket: str, key: str,
                       data, **kw):
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "PutInlineKey", rv, rb,
            lambda om: om.put_inline_key(rv, rb, key, data, **kw),
            write=True)

    def commit_keys(self, volume: str, bucket: str, slab: dict,
                    entries: list):
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "CommitKeys", rv, rb,
            lambda om: om.commit_keys(rv, rb, slab, entries),
            write=True)

    def slab_info(self, volume: str, bucket: str, slab_id: str) -> dict:
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "SlabInfo", rv, rb,
            lambda om: om.slab_info(rv, rb, slab_id))

    def list_slabs(self, volume: str, bucket: str) -> list:
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "ListSlabs", rv, rb,
            lambda om: om.list_slabs(rv, rb))

    def list_keys(self, volume: str, bucket: str, *a, **kw):
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed("ListKeys", rv, rb,
                            lambda om: om.list_keys(rv, rb, *a, **kw))

    def delete_key(self, volume: str, bucket: str, key: str, *a, **kw):
        rv, rb = self.resolve_bucket(volume, bucket)
        return self._routed(
            "DeleteKey", rv, rb,
            lambda om: om.delete_key(rv, rb, key, *a, **kw), write=True)

    def rename_key(self, volume: str, bucket: str, key: str,
                   new_key: str) -> None:
        rv, rb = self.resolve_bucket(volume, bucket)
        self._routed("RenameKey", rv, rb,
                     lambda om: om.rename_key(rv, rb, key, new_key),
                     write=True)

    def rename_key_cross(self, volume: str, src_bucket: str, key: str,
                         dst_bucket: str, new_key: str) -> dict:
        """Cross-bucket rename (the op that can span shards): always the
        2PC; a same-shard pair runs both halves on one ring."""
        rv, rb = self.resolve_bucket(volume, src_bucket)
        dv, db = self.resolve_bucket(volume, dst_bucket)
        if rv != dv:
            raise rq.OMError(rq.INVALID_REQUEST,
                             "cross-volume rename is not supported")
        return self._plane.coordinator.rename_cross(
            rv, rb, key, db, new_key)

    def key_block_groups(self, info: dict):
        return self._shard0.om.key_block_groups(info)

    # -- everything else: shard 0's leader (KMS, tokens, snapshots ...)
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._shard0.om, name)
