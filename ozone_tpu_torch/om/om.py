"""OzoneManager: the namespace service (volumes, buckets, keys).

Port of `ozone_tpu/om/om.py` (the reference's OzoneManager and
KeyManagerImpl surface): volume and bucket CRUD, open-key sessions with
SCM block allocation, commit (with the rewrite fence), lookup, list and
delete; key attributes; S3 secrets; multipart uploads and the open-key
and multipart expiry services (om/multipart.py); the upgrade status, in
its finalized form; the small-object surface (the bucket opt-in, inline
PUTs, the batched needle commit, slab allocation and listing, needle
lookups joined to their slab's groups, slab compaction); bucket
lifecycle rules and the sweeper's triggers (`lifecycle/service.py`,
built on first use over `clients` and `device` unless a daemon installs
its own in `self.lifecycle`). Writes go through the request/apply split
(om/requests.py) with a group commit before the acknowledgement; reads
go to the store directly. The key-deleting service hands deleted keys'
blocks to the SCM's deletion log, and a dead needle's bytes to its
slab's counters. `prepare` quiesces writes behind a durable marker (the
HA ring replicates it, `consensus/meta_ring.py`). Left out for later
slices: ACL checks and the authorizer, tenants, block tokens, encryption
(TDE/GDPR), link buckets, sharding, the upgrade finalizer and its layout
gate, FSO, snapshots, geo replication, hsync and lease recovery.
"""

from __future__ import annotations

import contextlib
import logging
import secrets
import threading
import uuid
from pathlib import Path
from typing import Any, Optional

from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.om import multipart as mpu
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import (
    OMMetadataStore,
    bucket_key,
    key_key,
    slab_key,
    volume_key,
)
from ozone_tpu_torch.scm.pipeline import ReplicationConfig
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.ids import BlockID
from ozone_tpu_torch.utils.metrics import MetricsRegistry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

#: the layout features `ozone_tpu/utils/upgrade.py` catalogs, (name,
#: version); the port has no finalizer, so all of them are allowed
FEATURES = (
    ("INITIAL", 0),
    ("EC_DEVICE_CODEC", 1),
    ("OM_REPLICATED_LOG", 2),
    ("BUCKET_SNAPSHOTS", 3),
    ("S3_CHUNKED_UPLOAD", 4),
    ("RATIS_STREAMING_WRITE", 5),
)
LATEST_VERSION = max(v for _, v in FEATURES)


class OpenKeySession:
    def __init__(self, info: dict, client_id: str):
        self.volume = info["volume"]
        self.bucket = info["bucket"]
        self.key = info["name"]
        self.client_id = client_id
        self.replication = ReplicationConfig.parse(info["replication"])
        self.checksum_type = info["checksum_type"]
        self.bytes_per_checksum = info["bytes_per_checksum"]
        #: rewrite fence the commit carries ("" / -1 = unfenced)
        self.expect_object_id = ""
        self.expect_generation = -1


class OzoneManager:
    def __init__(
        self,
        db_path: Path,
        scm: StorageContainerManager,
        block_size: int = 16 * 1024 * 1024,
        clients=None,
        device="cuda",
    ):
        self.store = OMMetadataStore(Path(db_path))
        self.scm = scm
        self.block_size = block_size
        #: datanode clients and codec device of the lifecycle service
        #: built on first use (tiering, slab compaction)
        self.clients = clients
        self.device = device
        self.metrics = MetricsRegistry("om")
        self._lock = threading.RLock()
        #: serializes this OM's SCM calls with the SCM's other users (a
        #: daemon sets the SCM service's lock here)
        self.scm_lock = contextlib.nullcontext()
        #: the lifecycle sweeper: a daemon installs its own; otherwise
        #: built with defaults by the first run_*_once
        self.lifecycle = None
        # durable upgrade-quiesce marker (OzoneManagerPrepareState)
        self._prepared = self.store.get("system", "om_prepared") is not None

    # ----------------------------------------------------------- requests
    def submit(self, request: rq.OMRequest) -> Any:
        """preExecute, then apply under the OM lock in one atomic batch,
        then a group commit: the request is durable before it is
        acknowledged, and concurrent submits share one sqlite commit."""
        self._check_not_prepared()
        with self.metrics.histogram(type(request).__name__).time(), \
                Tracer.instance().span("om:submit",
                                       request=type(request).__name__):
            request.pre_execute(self)
            with self._lock:
                # again under the lock: a write that passed the first
                # check must not apply after prepare()'s flush point
                self._check_not_prepared()
                with self.store.atomic():
                    result = request.apply(self.store)
            self.store.flush_group()
            self.metrics.counter("write_ops").inc()
            return result

    def _check_not_prepared(self) -> None:
        if self.prepared:
            raise rq.OMError(
                "OM_PREPARED", "OM is prepared for upgrade; writes are "
                "rejected until cancelprepare")

    # ----------------------------------------------------------- prepare
    def prepare(self) -> int:
        """Quiesce writes for a coordinated upgrade (`ozone om prepare`):
        flush, reject writes until cancel_prepare, return the prepared
        txid. The marker is durable, so a restart stays prepared."""
        with self._lock:
            self.store.put("system", "om_prepared", {"prepared": True})
            self.store.flush()
            self._prepared = True
            return self.store.txid

    def cancel_prepare(self) -> None:
        with self._lock:
            self.store.delete("system", "om_prepared")
            self.store.flush()
            self._prepared = False

    def reload_prepared(self) -> None:
        """Re-read the durable marker (after a snapshot install replaced
        the tables)."""
        with self._lock:
            self._prepared = \
                self.store.get("system", "om_prepared") is not None

    @property
    def prepared(self) -> bool:
        return self._prepared

    def upgrade_status(self) -> dict:
        """The cluster's finalization view, the reference's answer with
        no finalizer: every feature allowed. Served for clients that read
        it (the `UpgradeStatus` RPC); nothing in the port gates on it."""
        return {
            "metadata_version": LATEST_VERSION,
            "software_version": LATEST_VERSION,
            "needs_finalization": False,
            "features": [{"name": n, "version": v, "allowed": True}
                         for n, v in FEATURES],
        }

    # ----------------------------------------------------------- volumes
    def create_volume(self, volume: str, owner: str = "root") -> None:
        self.submit(rq.CreateVolume(volume, owner))

    def delete_volume(self, volume: str) -> None:
        self.submit(rq.DeleteVolume(volume))

    def volume_info(self, volume: str) -> dict:
        v = self.store.get("volumes", volume_key(volume))
        if v is None:
            raise rq.OMError(rq.VOLUME_NOT_FOUND, volume)
        return v

    def list_volumes(self) -> list[dict]:
        return [v for _, v in self.store.iterate("volumes")]

    # ----------------------------------------------------------- buckets
    def create_bucket(self, volume: str, bucket: str,
                      replication: str = "rs-6-3-1024k",
                      layout: str = "OBJECT_STORE") -> None:
        # fail fast on a bad scheme string instead of at the first PUT
        ReplicationConfig.parse(replication)
        self.submit(rq.CreateBucket(volume, bucket, replication, layout))

    def delete_bucket(self, volume: str, bucket: str) -> None:
        self.submit(rq.DeleteBucket(volume, bucket))

    def bucket_info(self, volume: str, bucket: str) -> dict:
        b = self.store.get("buckets", bucket_key(volume, bucket))
        if b is None:
            raise rq.OMError(rq.BUCKET_NOT_FOUND, f"{volume}/{bucket}")
        if b.get("source") or b.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            raise rq.OMError(rq.INVALID_REQUEST,
                             f"{volume}/{bucket}: link and FSO buckets are "
                             f"not served by this port")
        return b

    def list_buckets(self, volume: str) -> list[dict]:
        return [
            b for _, b in self.store.iterate("buckets", volume_key(volume) + "/")
        ]

    @staticmethod
    def _is_legacy(binfo: dict) -> bool:
        return binfo.get("layout") == "LEGACY"

    # ----------------------------------------------------------- keys
    def open_key(
        self,
        volume: str,
        bucket: str,
        key: str,
        replication: Optional[str] = None,
        metadata: Optional[dict] = None,
    ) -> OpenKeySession:
        binfo = self.bucket_info(volume, bucket)
        repl = replication or binfo["replication"]
        if replication:
            # a bad per-key scheme refuses the PUT before any row lands
            try:
                ReplicationConfig.parse(replication)
            except Exception as e:
                raise rq.OMError(
                    rq.INVALID_REQUEST,
                    f"bad per-key replication {replication!r}: {e}")
        client_id = uuid.uuid4().hex[:16]
        legacy = self._is_legacy(binfo)
        if legacy:
            key = rq.normalize_fs_path(key)
        self.submit(rq.OpenKey(volume, bucket, key, client_id, repl,
                               metadata=metadata or {}, fs_paths=legacy))
        info = self.store.get("open_keys",
                              f"{key_key(volume, bucket, key)}/{client_id}")
        self.metrics.counter("keys_opened").inc()
        return OpenKeySession(info, client_id)

    def allocate_block(
        self, session: OpenKeySession, excluded: Optional[list[str]] = None,
        excluded_containers: Optional[list[int]] = None,
    ) -> BlockGroup:
        """SCM block allocation for an open key."""
        with self.scm_lock:
            return self.scm.allocate_block(
                session.replication, self.block_size, excluded,
                excluded_containers,
            )

    def commit_key(self, session: OpenKeySession, groups: list[BlockGroup],
                   size: int) -> None:
        self.submit(rq.CommitKey(
            session.volume,
            session.bucket,
            session.key,
            session.client_id,
            size,
            [g.to_json() for g in groups],
            replication=str(session.replication),
            expect_object_id=session.expect_object_id,
            expect_generation=int(session.expect_generation),
        ))
        self.metrics.counter("keys_committed").inc()

    def lookup_key(self, volume: str, bucket: str, key: str) -> dict:
        binfo = self.bucket_info(volume, bucket)
        if self._is_legacy(binfo):
            key = rq.normalize_fs_path(key)
        info = self.store.get("keys", key_key(volume, bucket, key))
        if info is None:
            raise rq.OMError(rq.KEY_NOT_FOUND, f"{volume}/{bucket}/{key}")
        self.metrics.counter("key_lookups").inc()
        return self._join_needle(volume, bucket, info)

    def _join_needle(self, volume: str, bucket: str, info: dict) -> dict:
        """A needle row holds only (slab, offset, length, crc): its lookup
        carries the slab's block groups, so the read path slices the
        needle out of the slab with ordinary ranged group reads."""
        nd = info.get("needle")
        if not nd:
            return info
        srow = self.store.get("slabs", slab_key(volume, bucket, nd["slab"]))
        if srow is None:
            raise rq.OMError(
                "SLAB_NOT_FOUND",
                f"slab {nd['slab']} missing for "
                f"{volume}/{bucket}/{info.get('name')}")
        info = dict(info)
        info["block_groups"] = srow["block_groups"]
        return info

    def key_block_groups(self, info: dict) -> list[BlockGroup]:
        """BlockGroup objects (with pipelines) of a key row."""
        return [BlockGroup.from_json(g) for g in info["block_groups"]]

    def list_keys(self, volume: str, bucket: str, prefix: str = "",
                  start_after: str = "",
                  limit: Optional[int] = None) -> list[dict]:
        """Key rows of a bucket, name-ordered, optionally resuming after
        `start_after` and capped at `limit`."""
        self.bucket_info(volume, bucket)  # raises BUCKET_NOT_FOUND
        base = bucket_key(volume, bucket) + "/"
        floor = (base + start_after) if start_after else ""
        return [
            k
            for _, k in self.store.iterate_range(
                "keys", base + prefix, start_after=floor,
                limit=None if limit is None else max(0, int(limit)),
            )
        ]

    def delete_key(self, volume: str, bucket: str, key: str,
                   expect_object_id: str = "") -> None:
        """Delete a key; `expect_object_id` ("" = unfenced) makes the
        delete conditional on the live row still being that version."""
        binfo = self.bucket_info(volume, bucket)
        if self._is_legacy(binfo):
            key = rq.normalize_fs_path(key)
        self.submit(rq.DeleteKey(volume, bucket, key,
                                 expect_object_id=expect_object_id))
        self.metrics.counter("keys_deleted").inc()

    def set_key_attrs(self, volume: str, bucket: str, key: str,
                      attrs: dict, preconds: Optional[dict] = None) -> dict:
        """Merge attributes onto a key (None values delete them);
        `preconds` maps attribute -> must-exist, checked in the apply."""
        self.bucket_info(volume, bucket)  # BUCKET_NOT_FOUND, FSO refused
        return self.submit(rq.SetKeyAttrs(volume, bucket, key, attrs,
                                          preconds or {}))

    # ----------------------------------------------------------- s3 secrets
    def get_s3_secret(self, access_id: str,
                      create: bool = True) -> Optional[str]:
        """The SigV4 secret of an access id, created on first use."""
        row = self.store.get("s3_secrets", access_id)
        if row is not None:
            return row["secret"]
        if not create:
            return None
        return self.submit(rq.SetS3Secret(access_id, secrets.token_hex(32),
                                          if_absent=True))

    def revoke_s3_secret(self, access_id: str) -> None:
        self.submit(rq.RevokeS3Secret(access_id))

    # ----------------------------------------------------------- small objects
    def set_bucket_smallobj(self, volume: str, bucket: str,
                            enabled: bool = True, inline_max: int = 0,
                            needle_max: int = 0) -> dict:
        """Opt a bucket into (or out of) the small-object path; the
        eligibility check runs in the apply."""
        return self.submit(rq.SetBucketSmallObj(
            volume, bucket, enabled=enabled,
            inline_max=int(inline_max), needle_max=int(needle_max)))

    def smallobj_conf(self, binfo: dict) -> Optional[dict]:
        """A bucket's effective inline/needle thresholds, or None."""
        from ozone_tpu_torch.client.slab import smallobj_conf

        return smallobj_conf(binfo)

    def put_inline_key(self, volume: str, bucket: str, key: str,
                       data: bytes, metadata: Optional[dict] = None
                       ) -> dict:
        """A tiny PUT in one request, the value on the key row. The size
        is gated against the bucket's inline threshold here."""
        import base64

        from ozone_tpu_torch.client.slab import METRICS as SMALLOBJ

        conf = self.smallobj_conf(self.bucket_info(volume, bucket))
        if conf is None:
            raise rq.OMError(
                rq.SMALLOBJ_NOT_SUPPORTED,
                f"{volume}/{bucket} has no small-object config")
        raw = bytes(data)
        if len(raw) > conf["inline_max"]:
            raise rq.OMError(
                rq.INVALID_REQUEST,
                f"{len(raw)} bytes exceeds inline_max "
                f"{conf['inline_max']}")
        info = self.submit(rq.PutInlineKey(
            volume, bucket, key, base64.b64encode(raw).decode("ascii"),
            len(raw), metadata or {}))
        SMALLOBJ.counter("inline_puts").inc()
        SMALLOBJ.counter("inline_bytes").inc(len(raw))
        return info

    def commit_keys(self, volume: str, bucket: str, slab: dict,
                    entries: list[dict]) -> dict:
        """Batched needle commit: N keys and the sealed slab directory in
        one request; per-entry rewrite fences are honoured one by one."""
        from ozone_tpu_torch.client.slab import METRICS as SMALLOBJ

        out = self.submit(rq.CommitKeys(volume, bucket, slab=slab,
                                        entries=list(entries)))
        SMALLOBJ.counter("commit_batches").inc()
        SMALLOBJ.counter("needles_committed").inc(
            len(out.get("committed", ())))
        return out

    def allocate_slab_group(self, replication: str,
                            excluded: Optional[list[str]] = None,
                            excluded_containers: Optional[list[int]]
                            = None) -> BlockGroup:
        """SCM allocation for a slab block (a slab is not a key: no open
        session)."""
        with self.scm_lock:
            return self.scm.allocate_block(
                ReplicationConfig.parse(replication), self.block_size,
                excluded, excluded_containers)

    def slab_info(self, volume: str, bucket: str, slab_id: str) -> dict:
        row = self.store.get("slabs", slab_key(volume, bucket, slab_id))
        if row is None:
            raise rq.OMError(rq.KEY_NOT_FOUND, f"slab {slab_id}")
        return row

    def list_slabs(self, volume: str, bucket: str) -> list[dict]:
        return [v for _, v in self.store.iterate(
            "slabs", bucket_key(volume, bucket) + "/")]

    def _lifecycle_service(self):
        if self.lifecycle is None:
            from ozone_tpu_torch.lifecycle.service import LifecycleService

            self.lifecycle = LifecycleService(self, clients=self.clients,
                                              device=self.device)
        return self.lifecycle

    def run_slab_compaction_once(self, max_slabs: Optional[int] = None
                                 ) -> dict:
        """One needle-compaction sweep, on the lifecycle service."""
        return self._lifecycle_service().compact_slabs_once(
            max_slabs=max_slabs)

    # ----------------------------------------------------------- lifecycle
    def set_bucket_lifecycle(self, volume: str, bucket: str,
                             rules: list[dict]) -> dict:
        """Install a bucket's lifecycle rules (prefix, age_days, action
        TRANSITION_TO_EC(target) or EXPIRE) on its row."""
        return self.submit(rq.SetBucketLifecycle(volume, bucket, rules))

    def get_bucket_lifecycle(self, volume: str, bucket: str) -> list[dict]:
        return self.bucket_info(volume, bucket).get("lifecycle", [])

    def delete_bucket_lifecycle(self, volume: str, bucket: str) -> None:
        self.submit(rq.DeleteBucketLifecycle(volume, bucket))

    def lifecycle_status(self) -> dict:
        """The sweeper's state (fencing term, cursor, last stats) and its
        live counters."""
        from ozone_tpu_torch.utils.metrics import registry

        row = self.store.get("system", "lifecycle_state") or {}
        return {
            "term": row.get("term"),
            "cursor": row.get("cursor") or {},
            "stats": row.get("stats") or {},
            "in_progress": bool(row.get("cursor")),
            "metrics": registry("lifecycle").snapshot(),
        }

    def run_lifecycle_once(self, max_keys: Optional[int] = None) -> dict:
        """One lifecycle sweep (the `lifecycle run-now` verb)."""
        return self._lifecycle_service().run_once(max_keys=max_keys)

    # ----------------------------------------------------------- multipart
    def _mpu_key_name(self, volume: str, bucket: str, key: str) -> str:
        if self._is_legacy(self.bucket_info(volume, bucket)):
            return rq.normalize_fs_path(key)
        return key

    def initiate_multipart_upload(
        self, volume: str, bucket: str, key: str,
        replication: Optional[str] = None, metadata: Optional[dict] = None,
    ) -> str:
        legacy = self._is_legacy(self.bucket_info(volume, bucket))
        if legacy:
            key = rq.normalize_fs_path(key)
        if replication:
            try:
                ReplicationConfig.parse(replication)
            except Exception as e:
                raise rq.OMError(
                    rq.INVALID_REQUEST,
                    f"bad per-key replication {replication!r}: {e}")
        return self.submit(mpu.InitiateMultipartUpload(
            volume, bucket, key, replication=replication or "",
            metadata=metadata or {}, fs_paths=legacy))

    def multipart_info(self, volume: str, bucket: str, key: str,
                       upload_id: str) -> dict:
        key = self._mpu_key_name(volume, bucket, key)
        info = self.store.get("multipart",
                              mpu.mpu_key(volume, bucket, key, upload_id))
        if info is None:
            raise rq.OMError(mpu.NO_SUCH_UPLOAD,
                             f"{volume}/{bucket}/{key}/{upload_id}")
        return info

    def open_multipart_part(self, volume: str, bucket: str, key: str,
                            upload_id: str) -> OpenKeySession:
        """The session one part's blocks are written under: the key
        datapath, recorded by commit_multipart_part."""
        info = self.multipart_info(volume, bucket, key, upload_id)
        return OpenKeySession(info, client_id=upload_id)

    def commit_multipart_part(self, session, part_number: int,
                              groups: list[BlockGroup], size: int,
                              etag: str) -> str:
        return self.submit(mpu.CommitMultipartPart(
            session.volume, session.bucket, session.key, session.client_id,
            part_number, size, etag, [g.to_json() for g in groups]))

    def complete_multipart_upload(self, volume: str, bucket: str, key: str,
                                  upload_id: str, parts: list[dict]) -> dict:
        legacy = self._is_legacy(self.bucket_info(volume, bucket))
        if legacy:
            key = rq.normalize_fs_path(key)
        return self.submit(mpu.CompleteMultipartUpload(
            volume, bucket, key, upload_id, parts, fs_paths=legacy))

    def abort_multipart_upload(self, volume: str, bucket: str, key: str,
                               upload_id: str) -> None:
        key = self._mpu_key_name(volume, bucket, key)
        self.submit(mpu.AbortMultipartUpload(volume, bucket, key, upload_id))

    def list_parts(self, volume: str, bucket: str, key: str,
                   upload_id: str) -> list[dict]:
        info = self.multipart_info(volume, bucket, key, upload_id)
        return sorted(info["parts"].values(), key=lambda p: p["part_number"])

    def list_multipart_uploads(self, volume: str, bucket: str,
                               prefix: str = "") -> list[dict]:
        base = bucket_key(volume, bucket) + "/"
        return [m for _, m in self.store.iterate("multipart", base + prefix)]

    def run_open_key_cleanup_once(self, max_age_s: float = 7 * 24 * 3600.0,
                                  limit: int = 256) -> int:
        return mpu.OpenKeyCleanupService(self, max_age_s).run_once(limit)

    def run_mpu_cleanup_once(self, max_age_s: float = 7 * 24 * 3600.0,
                             limit: int = 256) -> int:
        return mpu.MultipartUploadCleanupService(self, max_age_s).run_once(
            limit)

    # ----------------------------------------------------------- services
    def run_key_deleting_service_once(self, limit: int = 100) -> int:
        """Purge deleted keys: hand their blocks to the SCM deletion log
        (which drives the datanode deletes over heartbeats), then drop
        the entries. Returns the keys purged."""
        entries = list(self.store.iterate("deleted_keys"))[:limit]
        if not entries:
            return 0
        purged: list[str] = []
        txs: list[tuple] = []
        dead_needles: dict[tuple, list[int]] = {}
        for dk, info in entries:
            vol, bkt = info.get("volume"), info.get("bucket")
            # a bucket with snapshots (written by the reference) defers:
            # a snapshot may still reference the blocks
            if vol and bkt and next(self.store.iterate(
                    "open_keys", f"/.snapmeta/{vol}/{bkt}/"), None):
                continue
            nd = info.get("needle")
            if nd:
                # the shared slab's blocks are never handed to the SCM
                # here: the needle's death is booked on the slab row, so
                # compaction sees the dead ratio grow
                acc = dead_needles.setdefault((vol, bkt, nd["slab"]),
                                              [0, 0])
                acc[0] += 1
                acc[1] += int(nd.get("length", info.get("size", 0)))
                purged.append(dk)
                continue
            for g in info.get("block_groups", []):
                txs.append((BlockID(g["container_id"], g["local_id"]),
                            list(g["nodes"])))
            purged.append(dk)
        if txs:
            with self.scm_lock:
                self.scm.delete_blocks(txs)
        for (vol, bkt, sid), (count, nbytes) in dead_needles.items():
            self.submit(rq.AccountDeadNeedles(vol, bkt, sid, count, nbytes))
        self.submit(rq.PurgeDeletedKeys(purged))
        return len(purged)

    def close(self) -> None:
        self.store.close()
