"""OzoneManager: the namespace service (volumes, buckets, keys).

Port of `ozone_tpu/om/om.py` (the reference's OzoneManager and
KeyManagerImpl surface): volume and bucket CRUD, open-key sessions with
SCM block allocation, commit (with the rewrite fence), lookup, list and
delete. Writes go through the request/apply split (om/requests.py) with
a group commit before the acknowledgement; reads go to the store
directly. The key-deleting service hands deleted keys' blocks to the
SCM's deletion log. Left out for later slices: HA, ACL checks and the
authorizer, tenants, block tokens, encryption (TDE/GDPR), link buckets,
sharding, prepare/upgrade, FSO, snapshots, multipart, small objects,
lifecycle and geo replication, hsync and lease recovery.
"""

from __future__ import annotations

import logging
import threading
import uuid
from pathlib import Path
from typing import Any, Optional

from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import (
    OMMetadataStore,
    bucket_key,
    key_key,
    volume_key,
)
from ozone_tpu_torch.scm.pipeline import ReplicationConfig
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.ids import BlockID
from ozone_tpu_torch.utils.metrics import MetricsRegistry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)


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
    ):
        self.store = OMMetadataStore(Path(db_path))
        self.scm = scm
        self.block_size = block_size
        self.metrics = MetricsRegistry("om")
        self._lock = threading.RLock()

    # ----------------------------------------------------------- requests
    def submit(self, request: rq.OMRequest) -> Any:
        """preExecute, then apply under the OM lock in one atomic batch,
        then a group commit: the request is durable before it is
        acknowledged, and concurrent submits share one sqlite commit."""
        with self.metrics.histogram(type(request).__name__).time(), \
                Tracer.instance().span("om:submit",
                                       request=type(request).__name__):
            request.pre_execute(self)
            with self._lock:
                with self.store.atomic():
                    result = request.apply(self.store)
            self.store.flush_group()
            self.metrics.counter("write_ops").inc()
            return result

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
                               fs_paths=legacy))
        info = self.store.get("open_keys",
                              f"{key_key(volume, bucket, key)}/{client_id}")
        self.metrics.counter("keys_opened").inc()
        return OpenKeySession(info, client_id)

    def allocate_block(
        self, session: OpenKeySession, excluded: Optional[list[str]] = None,
        excluded_containers: Optional[list[int]] = None,
    ) -> BlockGroup:
        """SCM block allocation for an open key."""
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

    def delete_key(self, volume: str, bucket: str, key: str) -> None:
        binfo = self.bucket_info(volume, bucket)
        if self._is_legacy(binfo):
            key = rq.normalize_fs_path(key)
        self.submit(rq.DeleteKey(volume, bucket, key))
        self.metrics.counter("keys_deleted").inc()

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
        for dk, info in entries:
            vol, bkt = info.get("volume"), info.get("bucket")
            # a bucket with snapshots (written by the reference) defers:
            # a snapshot may still reference the blocks
            if vol and bkt and next(self.store.iterate(
                    "open_keys", f"/.snapmeta/{vol}/{bkt}/"), None):
                continue
            if info.get("needle"):
                continue  # a slab's shared blocks: not this port's to purge
            for g in info.get("block_groups", []):
                txs.append((BlockID(g["container_id"], g["local_id"]),
                            list(g["nodes"])))
            purged.append(dk)
        if txs:
            self.scm.delete_blocks(txs)
        self.submit(rq.PurgeDeletedKeys(purged))
        return len(purged)

    def close(self) -> None:
        self.store.close()
