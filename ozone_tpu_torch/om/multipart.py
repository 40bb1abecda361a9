"""OM multipart upload: initiate, commit part, complete, abort, and the
open-key and multipart expiry services.

Port of `ozone_tpu/om/multipart.py` (the reference's S3InitiateMultipart
Upload / S3MultipartUploadCommitPart / S3MultipartUploadComplete /
S3MultipartUploadAbort requests and its OpenKeyCleanupService and
MultipartUploadCleanupService): upload state lives in the OM's
`multipart` table keyed by /volume/bucket/key/uploadId; each part carries
its own block groups; complete stitches the listed parts in part-number
order into the key row and routes every replaced or orphaned part's
blocks into the deleted-keys purge chain. Rows are the reference's JSON.
The open-key expiry seals an expired hsync session by lease recovery.
Left out: snapshot pre-images (snapshots are not ported) and encrypted
uploads.
"""

from __future__ import annotations

import hashlib
import logging
import time
import uuid
from dataclasses import dataclass, field

from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import bucket_key, key_key

log = logging.getLogger(__name__)

NO_SUCH_UPLOAD = "NO_SUCH_MULTIPART_UPLOAD"
INVALID_PART = "INVALID_PART"


def mpu_key(volume: str, bucket: str, key: str, upload_id: str) -> str:
    return f"{key_key(volume, bucket, key)}/{upload_id}"


def _final_etag(listed: list[dict]) -> str:
    """The S3 composite ETag: the MD5 of the stored parts' hex ETags
    joined, then `-<number of parts>`."""
    joined = "".join(p["etag"] for p in listed)
    return hashlib.md5(joined.encode()).hexdigest() + f"-{len(listed)}"


def _release_blocks(store, info: dict, ts: float, tag: str) -> None:
    """Route a part's or key's blocks into the deleted-keys purge chain."""
    if info.get("block_groups"):
        rq.erase_gdpr_secret(info)
        store.put("deleted_keys", f"{tag}:{ts}", info)


@dataclass
class InitiateMultipartUpload(rq.OMRequest):
    volume: str
    bucket: str
    key: str
    upload_id: str = ""
    replication: str = ""
    checksum_type: str = "CRC32C"
    bytes_per_checksum: int = 16 * 1024
    created: float = 0.0
    metadata: dict = field(default_factory=dict)
    #: LEGACY bucket: the key is normalized; enforce filesystem shape
    fs_paths: bool = False

    def pre_execute(self, om) -> None:
        self.created = time.time()
        if not self.upload_id:
            self.upload_id = uuid.uuid4().hex
        if not self.replication:
            self.replication = om.bucket_info(self.volume,
                                              self.bucket)["replication"]

    def apply(self, store):
        if not store.exists("buckets", bucket_key(self.volume, self.bucket)):
            raise rq.OMError(rq.BUCKET_NOT_FOUND,
                             f"{self.volume}/{self.bucket}")
        if self.fs_paths:
            rq.check_fs_conflicts(store, self.volume, self.bucket, self.key)
        store.put(
            "multipart",
            mpu_key(self.volume, self.bucket, self.key, self.upload_id),
            {
                "volume": self.volume,
                "bucket": self.bucket,
                "name": self.key,
                "upload_id": self.upload_id,
                "replication": self.replication,
                "checksum_type": self.checksum_type,
                "bytes_per_checksum": self.bytes_per_checksum,
                "created": self.created,
                "parts": {},
                "metadata": dict(self.metadata),
            },
        )
        return self.upload_id


@dataclass
class CommitMultipartPart(rq.OMRequest):
    """Record one uploaded part; re-uploading a part number replaces it
    and sends the replaced part's blocks to the purge chain."""

    volume: str
    bucket: str
    key: str
    upload_id: str
    part_number: int
    size: int
    etag: str
    block_groups: list[dict] = field(default_factory=list)
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        mk = mpu_key(self.volume, self.bucket, self.key, self.upload_id)
        mpu = store.get("multipart", mk)
        if mpu is None:
            raise rq.OMError(NO_SUCH_UPLOAD, mk)
        part_no = str(self.part_number)
        old = mpu["parts"].get(part_no)
        if old is not None:
            _release_blocks(store, old, self.ts, f"{mk}/part{part_no}")
        mpu["parts"][part_no] = {
            "volume": self.volume,
            "bucket": self.bucket,
            "part_number": self.part_number,
            "size": self.size,
            "etag": self.etag,
            "block_groups": self.block_groups,
            "modified": self.ts,
        }
        store.put("multipart", mk, mpu)
        return self.etag


@dataclass
class CompleteMultipartUpload(rq.OMRequest):
    """Stitch the listed parts, in part-number order, into the key: the
    parts must exist with matching ETags and be listed in ascending
    order; parts uploaded but not listed, and a previous version of the
    key, go to the purge chain."""

    volume: str
    bucket: str
    key: str
    upload_id: str
    parts: list[dict] = field(default_factory=list)  # {part_number, etag}
    ts: float = 0.0
    #: LEGACY bucket: enforce filesystem shape on the final key
    fs_paths: bool = False
    #: stable identity of the assembled key version (OmKeyInfo objectID)
    key_id: str = ""

    def pre_execute(self, om) -> None:
        self.ts = time.time()
        self.key_id = uuid.uuid4().hex[:16]

    def apply(self, store):
        mk = mpu_key(self.volume, self.bucket, self.key, self.upload_id)
        mpu = store.get("multipart", mk)
        if mpu is None:
            raise rq.OMError(NO_SUCH_UPLOAD, mk)
        if self.fs_paths:
            # the namespace may have changed since the initiate
            rq.check_fs_conflicts(store, self.volume, self.bucket, self.key)
        listed: list[dict] = []
        prev = 0
        for p in self.parts:
            n = int(p["part_number"])
            if n <= prev:
                raise rq.OMError(INVALID_PART,
                                 f"part numbers not ascending at {n}")
            prev = n
            part = mpu["parts"].get(str(n))
            if part is None or part["etag"] != p.get("etag", part["etag"]):
                raise rq.OMError(INVALID_PART, f"part {n}")
            listed.append(part)
        if not listed:
            raise rq.OMError(INVALID_PART, "no parts listed")
        kk = key_key(self.volume, self.bucket, self.key)
        old = store.get("keys", kk)
        markers = (rq.missing_parent_markers(store, self.volume, self.bucket,
                                             self.key)
                   if self.fs_paths else [])
        # quota before any mutation: a refused complete leaves the upload
        # intact for a retry once space is freed
        rq.check_and_charge_quota(
            store, self.volume, self.bucket,
            sum(p["size"] for p in listed)
            - (int(old.get("size", 0)) if old else 0),
            (0 if old is not None else 1) + len(markers),
        )
        if markers:
            rq.put_parent_markers(store, self.volume, self.bucket, markers,
                                  mpu["replication"], self.ts)
        listed_nos = {str(int(p["part_number"])) for p in self.parts}
        for no, part in mpu["parts"].items():
            if no not in listed_nos:
                _release_blocks(store, part, self.ts, f"{mk}/part{no}")
        if old is not None:
            _release_blocks(store, old, self.ts, kk)
        info = {
            "volume": self.volume,
            "bucket": self.bucket,
            "name": self.key,
            "object_id": self.key_id,
            "replication": mpu["replication"],
            "checksum_type": mpu["checksum_type"],
            "bytes_per_checksum": mpu["bytes_per_checksum"],
            "size": sum(p["size"] for p in listed),
            "block_groups": [g for p in listed for g in p["block_groups"]],
            "etag": _final_etag(listed),
            "created": mpu["created"],
            "modified": self.ts,
        }
        if mpu.get("metadata"):
            info["metadata"] = mpu["metadata"]
        store.put("keys", kk, info)
        store.delete("multipart", mk)
        return info


@dataclass
class AbortMultipartUpload(rq.OMRequest):
    volume: str
    bucket: str
    key: str
    upload_id: str
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        mk = mpu_key(self.volume, self.bucket, self.key, self.upload_id)
        mpu = store.get("multipart", mk)
        if mpu is None:
            raise rq.OMError(NO_SUCH_UPLOAD, mk)
        for no, part in mpu["parts"].items():
            _release_blocks(store, part, self.ts, f"{mk}/part{no}")
        store.delete("multipart", mk)


@dataclass
class PurgeExpiredOpenKeys(rq.OMRequest):
    """Drop expired open-key sessions. An open session holds no committed
    block groups, so dropping its row is enough."""

    entries: list[str] = field(default_factory=list)

    def apply(self, store):
        for k in self.entries:
            store.delete("open_keys", k)


class OpenKeyCleanupService:
    """Purge open-key sessions older than max_age. An hsynced session
    whose writer stopped syncing for max_age belongs to a dead writer:
    its key is sealed at the last synced length by lease recovery
    instead of being discarded."""

    def __init__(self, om, max_age_s: float = 7 * 24 * 3600.0):
        self.om = om
        self.max_age_s = max_age_s

    def run_once(self, limit: int = 256) -> int:
        cutoff = time.time() - self.max_age_s
        expired = []
        hsynced = []
        for k, info in self.om.store.iterate("open_keys"):
            # snapshot markers (a database the reference wrote) are not
            # sessions
            if k.startswith("/.snapmeta/"):
                continue
            if info.get("hsync_client_id"):
                # a live hsync stream refreshes "modified" on every sync
                if max(info.get("created", 0),
                       info.get("modified", 0)) < cutoff:
                    hsynced.append(info)
            elif info.get("created", 0) < cutoff:
                expired.append(k)
        expired = expired[:limit]
        if expired:
            self.om.submit(PurgeExpiredOpenKeys(expired))
        for info in hsynced[:limit]:
            try:
                self.om.recover_lease(info["volume"], info["bucket"],
                                      info["name"])
            except rq.OMError:
                log.warning("lease recovery failed for %s/%s/%s",
                            info["volume"], info["bucket"], info["name"])
        return len(expired) + len(hsynced[:limit])


class MultipartUploadCleanupService:
    """Abort multipart uploads older than max_age with the request a
    client abort submits, so their parts' blocks reach the purge chain."""

    def __init__(self, om, max_age_s: float = 7 * 24 * 3600.0):
        self.om = om
        self.max_age_s = max_age_s

    def run_once(self, limit: int = 256) -> int:
        cutoff = time.time() - self.max_age_s
        expired = [mpu for _, mpu in self.om.store.iterate("multipart")
                   if mpu.get("created", 0) < cutoff][:limit]
        for mpu in expired:
            self.om.submit(AbortMultipartUpload(
                mpu["volume"], mpu["bucket"], mpu["name"], mpu["upload_id"]))
        return len(expired)
