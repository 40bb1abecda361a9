"""OM write requests: the preExecute / apply split.

Port of the namespace and key requests of `ozone_tpu/om/requests.py` (the
reference's OMClientRequest pattern: `pre_execute(om)` normalizes and
assigns ids and timestamps on the leader, `apply(store)` is the
deterministic mutation every replica would run). Rows are the
reference's JSON, field for field. Kept: volume and bucket create and
delete, key open (with the user metadata an S3 PUT carries), commit
(with the quota charge, the overwrite's move to the purge chain and the
rewrite fence), delete (with the expiry's object-id fence) and purge,
for OBJECT_STORE and LEGACY buckets; key attributes (S3 object tags ride
them); S3 secrets; the small-object verbs (the bucket opt-in, inline
keys, the batched needle commit, dead-needle accounting and slab
retirement); bucket lifecycle rules and the sweeper's term-fenced
checkpoint; the hsync-aware commit tail, lease recovery, the OBS and
LEGACY key rename, link buckets (a bucket row naming its source) and
filesystem attributes on the bucket row. The multipart requests are in
`om/multipart.py`, the FSO directory-tree requests in `om/fso.py`. The
security requests: native ACL changes on volume, bucket, key and prefix
rows (`ModifyAcl`, with the OBS/FSO key resolution of `_acl_target`), the
S3 bucket grants (`SetBucketAcl`), tenants and their access ids, and the
delegation tokens' master keys, rows, renewals, cancels and purge.
Encryption: a bucket's KMS master key (`encryption_key`, checked against
the KMS at create) or its GDPR flag, the envelope bundle an open carries
in the replicated request (`OpenKey.encryption`: an EDEK, or a GDPR
bucket's per-key secret), the master keys' mint and rotation
(`CreateMasterKey`), and the GDPR secret erased in the apply that
deletes or overwrites a key (`erase_gdpr_secret`). Bucket snapshots:
`CreateSnapshot`, `DeleteSnapshot` (with its merge-down into the older
copy-on-write snapshot) and `RenameSnapshot` keep the chain's rows in
`open_keys` under `/.snapmeta/`, and every apply that mutates or
deletes a key, file or directory row first calls `preserve_preimage` or
`preserve_fso_preimage`, which copies the row's pre-image into the
newest snapshot's overlay under `/.snapshot/` in `keys` (the reads are
in `om/snapshots.py`). Quotas (`SetQuota`, `ApplyQuotaRepair`), volume
ownership (`SetVolumeOwner`) and a bucket's default replication
(`SetBucketReplication`). Geo replication: a bucket's cross-cluster
rules on its row (`SetBucketGeoReplication`, refused on an FSO bucket,
and `DeleteBucketGeoReplication`) and the shipper's term-fenced state in
`system/geo_state` (`GeoCheckpoint`). `to_json` and `from_json` are the reference's wire form for the
replicated log (`om/ha.py`, `consensus/meta_ring.py`).
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from ozone_tpu_torch.om.metadata import (
    OMMetadataStore,
    bucket_key,
    key_key,
    slab_key,
    volume_key,
)


class OMError(Exception):
    def __init__(self, code: str, msg: str = ""):
        super().__init__(f"{code}: {msg}" if msg else code)
        self.code = code
        self.msg = msg  # bare message for re-wrapping without code stacking


VOLUME_NOT_FOUND = "VOLUME_NOT_FOUND"
VOLUME_ALREADY_EXISTS = "VOLUME_ALREADY_EXISTS"
VOLUME_NOT_EMPTY = "VOLUME_NOT_EMPTY"
BUCKET_NOT_FOUND = "BUCKET_NOT_FOUND"
BUCKET_ALREADY_EXISTS = "BUCKET_ALREADY_EXISTS"
BUCKET_NOT_EMPTY = "BUCKET_NOT_EMPTY"
KEY_NOT_FOUND = "KEY_NOT_FOUND"
KEY_MODIFIED = "KEY_MODIFIED"
DANGLING_LINK = "DANGLING_LINK"
QUOTA_EXCEEDED = "QUOTA_EXCEEDED"
FILE_ALREADY_EXISTS = "FILE_ALREADY_EXISTS"
NOT_A_DIRECTORY = "NOT_A_DIRECTORY"
INVALID_REQUEST = "INVALID_REQUEST"
SMALLOBJ_NOT_SUPPORTED = "SMALLOBJ_NOT_SUPPORTED"
LIFECYCLE_FENCED = "LIFECYCLE_FENCED"
GEO_FENCED = "GEO_FENCED"
PREFIX_NOT_FOUND = "PREFIX_NOT_FOUND"
TENANT_ALREADY_EXISTS = "TENANT_ALREADY_EXISTS"
TENANT_NOT_FOUND = "TENANT_NOT_FOUND"
TENANT_NOT_EMPTY = "TENANT_NOT_EMPTY"
ACCESS_ID_NOT_FOUND = "ACCESS_ID_NOT_FOUND"
ACCESS_ID_ALREADY_EXISTS = "ACCESS_ID_ALREADY_EXISTS"
PERMISSION_DENIED = "PERMISSION_DENIED"
TOKEN_ERROR = "TOKEN_ERROR"


#: request class name -> class, for the replicated log's wire form
_REQUEST_TYPES: dict[str, type] = {}


@dataclass
class OMRequest:
    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _REQUEST_TYPES[cls.__name__] = cls

    def pre_execute(self, om: Any) -> None:  # noqa: D401
        """Leader-side phase; default no-op."""

    def apply(self, store: OMMetadataStore) -> Any:
        raise NotImplementedError

    def to_json(self) -> dict:
        """Wire form for the replicated log: the post-preExecute state,
        so followers apply without running preExecute again."""
        import dataclasses

        return {"type": type(self).__name__, **dataclasses.asdict(self)}

    @staticmethod
    def from_json(d: dict) -> "OMRequest":
        d = dict(d)
        cls = _REQUEST_TYPES[d.pop("type")]
        return cls(**d)


@dataclass
class CreateVolume(OMRequest):
    volume: str
    owner: str = "root"
    quota_bytes: int = -1
    created: float = 0.0

    def pre_execute(self, om) -> None:
        self.created = time.time()

    def apply(self, store):
        k = volume_key(self.volume)
        if store.exists("volumes", k):
            raise OMError(VOLUME_ALREADY_EXISTS, self.volume)
        store.put(
            "volumes",
            k,
            {
                "name": self.volume,
                "owner": self.owner,
                "quota_bytes": self.quota_bytes,
                "created": self.created,
            },
        )


@dataclass
class DeleteVolume(OMRequest):
    volume: str

    def apply(self, store):
        k = volume_key(self.volume)
        if not store.exists("volumes", k):
            raise OMError(VOLUME_NOT_FOUND, self.volume)
        if next(store.iterate("buckets", k + "/"), None) is not None:
            raise OMError(VOLUME_NOT_EMPTY, self.volume)
        store.delete("volumes", k)


@dataclass
class CreateBucket(OMRequest):
    volume: str
    bucket: str
    replication: str = "rs-6-3-1024k"
    layout: str = "OBJECT_STORE"
    versioning: bool = False
    created: float = 0.0
    #: a LINK bucket (`sh bucket link`): a named alias whose key
    #: operations resolve to the source bucket
    source_volume: str = ""
    source_bucket: str = ""
    #: TDE: the KMS master key every key of this bucket gets an EDEK
    #: under (BucketEncryptionKeyInfo); "" = plaintext
    encryption_key: str = ""
    #: GDPR right to erasure: a per-key secret destroyed in the apply
    #: that deletes the key
    gdpr: bool = False

    #: the reference's three bucket layouts: OBS (flat object table),
    #: FSO (directory tree tables, `om/fso.py`) and LEGACY (flat table
    #: with filesystem path semantics)
    LAYOUTS = ("OBJECT_STORE", "FILE_SYSTEM_OPTIMIZED", "LEGACY")

    def pre_execute(self, om) -> None:
        self.created = time.time()
        if self.encryption_key:
            # fail at the create, not at the first write
            om.kms.master_info(self.encryption_key)

    def apply(self, store):
        from ozone_tpu_torch.om.acl import inherit_defaults

        if self.layout not in self.LAYOUTS:
            raise OMError(INVALID_REQUEST,
                          f"unknown bucket layout {self.layout!r}")
        vrow = store.get("volumes", volume_key(self.volume))
        if vrow is None:
            raise OMError(VOLUME_NOT_FOUND, self.volume)
        k = bucket_key(self.volume, self.bucket)
        if store.exists("buckets", k):
            raise OMError(BUCKET_ALREADY_EXISTS, k)
        row = {
            "volume": self.volume,
            "name": self.bucket,
            "replication": self.replication,
            "layout": self.layout,
            "versioning": self.versioning,
            "created": self.created,
            "acls": inherit_defaults(vrow.get("acls", [])),
        }
        if self.encryption_key:
            row["encryption_key"] = self.encryption_key
        if self.gdpr:
            row["gdpr"] = True
        if self.source_volume and self.source_bucket:
            # links may be created before their source: a dangling link
            # resolves lazily and errors on use
            row["source"] = {"volume": self.source_volume,
                             "bucket": self.source_bucket}
        store.put("buckets", k, row)


@dataclass
class DeleteBucket(OMRequest):
    volume: str
    bucket: str

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        if not store.exists("buckets", k):
            raise OMError(BUCKET_NOT_FOUND, k)
        # a bucket written by the reference's FSO layout keeps keys in
        # dirs/files: those count as content too
        for table in ("keys", "files", "dirs", "deleted_dirs"):
            if next(store.iterate(table, k + "/"), None) is not None:
                raise OMError(BUCKET_NOT_EMPTY, k)
        store.delete("buckets", k)


def check_and_charge_quota(
    store, volume: str, bucket: str, bytes_delta: int, keys_delta: int
) -> None:
    """Enforce volume and bucket space and namespace quotas on growth,
    then update the usage counters. A quota of -1 means unlimited."""
    bk = bucket_key(volume, bucket)
    vk = volume_key(volume)
    brow = store.get("buckets", bk)
    vrow = store.get("volumes", vk)
    if bytes_delta > 0 or keys_delta > 0:
        if brow is not None:
            bq = int(brow.get("quota_bytes", -1))
            used = int(brow.get("used_bytes", 0))
            if bq >= 0 and used + bytes_delta > bq:
                raise OMError(
                    QUOTA_EXCEEDED,
                    f"bucket {bk}: {used} + {bytes_delta} > quota {bq}",
                )
            nq = int(brow.get("quota_namespace", -1))
            kc = int(brow.get("key_count", 0))
            if nq >= 0 and kc + keys_delta > nq:
                raise OMError(
                    QUOTA_EXCEEDED,
                    f"bucket {bk}: {kc + keys_delta} keys > quota {nq}",
                )
        if vrow is not None:
            vq = int(vrow.get("quota_bytes", -1))
            vused = int(vrow.get("used_bytes", 0))
            if vq >= 0 and vused + bytes_delta > vq:
                raise OMError(
                    QUOTA_EXCEEDED,
                    f"volume /{volume}: {vused} + {bytes_delta} > "
                    f"quota {vq}",
                )
            vnq = int(vrow.get("quota_namespace", -1))
            vkc = int(vrow.get("key_count", 0))
            if vnq >= 0 and vkc + keys_delta > vnq:
                raise OMError(
                    QUOTA_EXCEEDED,
                    f"volume /{volume}: {vkc + keys_delta} keys > "
                    f"quota {vnq}",
                )
    if brow is not None:
        brow["used_bytes"] = max(
            0, int(brow.get("used_bytes", 0)) + bytes_delta)
        brow["key_count"] = max(
            0, int(brow.get("key_count", 0)) + keys_delta)
        store.put("buckets", bk, brow)
    if vrow is not None:
        vrow["used_bytes"] = max(
            0, int(vrow.get("used_bytes", 0)) + bytes_delta)
        vrow["key_count"] = max(
            0, int(vrow.get("key_count", 0)) + keys_delta)
        store.put("volumes", vk, vrow)


def erase_gdpr_secret(info: dict) -> None:
    """Crypto-erasure of a key row written by a GDPR bucket: its per-key
    secret dies in the same apply that deletes the key."""
    enc = info.get("encryption")
    if enc and "gdpr_secret" in enc:
        info["encryption"] = {"erased": True}


def direct_sessions_of(store, ek: str) -> list[str]:
    """Open-session storage keys of entry `ek` itself, not of longer key
    names that extend it with a slash (OBS key names may hold slashes;
    client ids never do)."""
    return [k for k, _ in store.iterate("open_keys", f"{ek}/")
            if "/" not in k[len(ek) + 1:]]


def finalize_commit(store, table: str, ek: str, info: dict, old,
                    client_id: str, hsync: bool, modified: float) -> None:
    """The hsync-aware commit tail of OBS keys and FSO files: charge quota
    (the new size minus what the previous version charged), bump the
    row's generation (hsyncs included), stamp `hsync_client_id` and keep
    the open session on an hsync or clear both on a final commit, and
    route a superseded previous version to the purge chain, fencing its
    writer first if it was a live hsync stream."""
    _, vol, bkt = ek.split("/", 3)[:3]
    # snapshots: capture the pre-overwrite image first
    if table == "keys":
        preserve_preimage(store, vol, bkt, ek)
    elif table == "files":
        preserve_fso_preimage(store, vol, bkt, "files", ek)
    check_and_charge_quota(
        store, vol, bkt,
        int(info.get("size", 0)) - (int(old.get("size", 0)) if old else 0),
        0 if old is not None else 1,
    )
    # per-commit generation (OmKeyInfo updateID): the rewrite fence
    # detects any commit in between by it
    info["generation"] = (int(old.get("generation", 0)) + 1
                          if old is not None else 1)
    if hsync:
        info["hsync_client_id"] = client_id
        store.put("open_keys", f"{ek}/{client_id}", info)  # stays open
    else:
        info.pop("hsync_client_id", None)
        store.delete("open_keys", f"{ek}/{client_id}")
    if (
        old is not None
        and (old.get("block_groups") or old.get("needle"))
        and old.get("hsync_client_id") != client_id
    ):
        stale_writer = old.get("hsync_client_id")
        if stale_writer:
            store.delete("open_keys", f"{ek}/{stale_writer}")
        erase_gdpr_secret(old)
        store.put("deleted_keys", f"{ek}:{modified}", old)
    store.put(table, ek, info)


def check_rewrite_fence(store, expect_object_id: str, old, open_k: str,
                        row_key: str, info: dict, modified: float,
                        expect_generation: int = -1) -> None:
    """When the fence is set and the live row no longer carries the
    expected object id and generation, hand the freshly written blocks to
    the purge chain so they don't leak, then refuse the commit with
    KEY_MODIFIED."""
    if not expect_object_id:
        return
    if (old is not None
            and old.get("object_id") == expect_object_id
            and (expect_generation < 0
                 or int(old.get("generation", 0)) == expect_generation)):
        return
    store.delete("open_keys", open_k)
    erase_gdpr_secret(info)
    store.put("deleted_keys", f"{row_key}:{modified}", info)
    raise OMError(KEY_MODIFIED,
                  f"{row_key} changed during rewrite; new data discarded")


@dataclass
class CommitKey(OMRequest):
    """Finalize a key: move the open-key session into the key table. With
    `hsync` it is the mid-write durability commit: the key is visible at
    the synced length and the session stays open for more writes."""

    volume: str
    bucket: str
    key: str
    client_id: str
    size: int
    block_groups: list[dict] = field(default_factory=list)
    replication: str = ""
    modified: float = 0.0
    hsync: bool = False
    #: rewrite fence: commit only if the live row still carries this
    #: object id ("" = unfenced) ...
    expect_object_id: str = ""
    #: ... and this generation (-1 = object id only)
    expect_generation: int = -1

    def pre_execute(self, om) -> None:
        self.modified = time.time()

    def apply(self, store):
        kk = key_key(self.volume, self.bucket, self.key)
        open_k = f"{kk}/{self.client_id}"
        if not store.exists("open_keys", open_k):
            raise OMError(KEY_NOT_FOUND, f"no open session {open_k}")
        info = store.get("open_keys", open_k)
        info.update(
            {
                "size": self.size,
                "block_groups": self.block_groups,
                "modified": self.modified,
            }
        )
        if "acls" not in info:
            from ozone_tpu_torch.om.acl import inherit_defaults

            b = store.get("buckets", bucket_key(self.volume, self.bucket))
            if b is not None:
                info["acls"] = inherit_defaults(b.get("acls", []))
        if info.pop("fs_paths", False):
            # LEGACY layout: materialize the missing parent directory
            # markers (quota-charged) before the key commit
            markers = missing_parent_markers(store, self.volume,
                                             self.bucket, self.key)
            if markers:
                check_and_charge_quota(store, self.volume, self.bucket,
                                       0, len(markers))
                put_parent_markers(store, self.volume, self.bucket,
                                   markers, self.replication,
                                   self.modified)
        old = store.get("keys", kk)
        check_rewrite_fence(store, self.expect_object_id, old, open_k,
                            kk, info, self.modified,
                            self.expect_generation)
        finalize_commit(store, "keys", kk, info, old, self.client_id,
                        self.hsync, self.modified)
        return info


def check_fs_conflicts(store, volume: str, bucket: str,
                       key: str) -> None:
    """LEGACY filesystem-shape invariants on the flat key table: a file and
    a directory marker may not share a name, and no ancestor of a new
    entry may be a plain file."""
    base = key.rstrip("/")
    if not key.endswith("/") and store.exists(
            "keys", key_key(volume, bucket, base + "/")):
        raise OMError(FILE_ALREADY_EXISTS,
                      f"{base} exists as a directory")
    if key.endswith("/") and store.exists(
            "keys", key_key(volume, bucket, base)):
        raise OMError(FILE_ALREADY_EXISTS, f"{base} exists as a file")
    parts = base.split("/")[:-1]
    for i in range(1, len(parts) + 1):
        anc = "/".join(parts[:i])
        if store.exists("keys", key_key(volume, bucket, anc)):
            raise OMError(NOT_A_DIRECTORY, f"ancestor {anc} is a file")


def missing_parent_markers(store, volume: str, bucket: str,
                           key: str) -> list[str]:
    parts = key.rstrip("/").split("/")[:-1]
    out = []
    for i in range(1, len(parts) + 1):
        marker = "/".join(parts[:i]) + "/"
        if not store.exists("keys", key_key(volume, bucket, marker)):
            out.append(marker)
    return out


def put_parent_markers(store, volume: str, bucket: str,
                       markers: list[str], replication: str,
                       ts: float) -> None:
    """Materialize LEGACY parent directory markers; the caller charges the
    namespace quota for them first, one count per marker."""
    for marker in markers:
        preserve_preimage(store, volume, bucket,
                          key_key(volume, bucket, marker))
        store.put("keys", key_key(volume, bucket, marker), {
            "volume": volume,
            "bucket": bucket,
            "name": marker,
            "replication": replication,
            "size": 0,
            "block_groups": [],
            "created": ts,
            "modified": ts,
        })


def normalize_fs_path(key: str) -> str:
    """LEGACY-bucket path normalization: collapse duplicate separators,
    strip a leading '/', refuse '.' and '..' segments; a trailing '/'
    (a directory marker) survives."""
    is_dir = key.endswith("/")
    parts = [p for p in key.split("/") if p]
    if not parts:
        raise OMError(INVALID_REQUEST, f"empty key {key!r}")
    for p in parts:
        if p in (".", ".."):
            raise OMError(INVALID_REQUEST,
                          f"illegal path segment {p!r} in {key!r}")
    return "/".join(parts) + ("/" if is_dir else "")


@dataclass
class OpenKey(OMRequest):
    """Record an open-key session (OMKeyCreateRequest). `fs_paths` marks a
    LEGACY bucket: ancestor file/directory conflicts are refused here and
    the commit materializes the missing parent markers."""

    volume: str
    bucket: str
    key: str
    client_id: str
    replication: str
    checksum_type: str = "CRC32C"
    bytes_per_checksum: int = 16 * 1024
    created: float = 0.0
    #: user metadata (the S3 x-amz-meta-* pairs), kept on the key row
    metadata: dict = field(default_factory=dict)
    fs_paths: bool = False
    #: the envelope bundle the OM minted at open (an EDEK for a TDE
    #: bucket, the per-key secret for a GDPR one); it rides the replicated
    #: request, so every replica stores the same bundle
    encryption: dict = field(default_factory=dict)
    #: stable identity of this key version (OmKeyInfo objectID)
    key_id: str = ""
    #: explicit key ACLs fixed at open (OmKeyArgs acls); empty = the
    #: commit inherits the bucket's DEFAULT grants
    acls: list = field(default_factory=list)

    def pre_execute(self, om) -> None:
        self.created = time.time()
        self.key_id = uuid.uuid4().hex[:16]

    def apply(self, store):
        if not store.exists("buckets", bucket_key(self.volume, self.bucket)):
            raise OMError(BUCKET_NOT_FOUND, f"{self.volume}/{self.bucket}")
        if self.fs_paths:
            check_fs_conflicts(store, self.volume, self.bucket, self.key)
        kk = key_key(self.volume, self.bucket, self.key)
        row = {
            "volume": self.volume,
            "bucket": self.bucket,
            "name": self.key,
            "object_id": self.key_id,
            "replication": self.replication,
            "checksum_type": self.checksum_type,
            "bytes_per_checksum": self.bytes_per_checksum,
            "size": 0,
            "block_groups": [],
            "created": self.created,
            "modified": self.created,
        }
        if self.metadata:
            row["metadata"] = dict(self.metadata)
        if self.acls:
            row["acls"] = list(self.acls)
        if self.fs_paths:
            row["fs_paths"] = True  # the commit materializes parent markers
        if self.encryption:
            row["encryption"] = dict(self.encryption)
        store.put("open_keys", f"{kk}/{self.client_id}", row)


@dataclass
class DeleteKey(OMRequest):
    """Move a key to the deleted table for the purge chain.
    `expect_object_id` ("" = unfenced) makes the delete conditional on
    the live row still being the scanned version: the lifecycle expiry
    uses it, so a user overwrite racing the sweep wins."""

    volume: str
    bucket: str
    key: str
    ts: float = 0.0
    expect_object_id: str = ""

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        kk = key_key(self.volume, self.bucket, self.key)
        info = store.get("keys", kk)
        if info is None:
            raise OMError(KEY_NOT_FOUND, kk)
        if self.expect_object_id and \
                info.get("object_id") != self.expect_object_id:
            raise OMError(KEY_MODIFIED,
                          f"{kk} overwritten since the expiry scan")
        preserve_preimage(store, self.volume, self.bucket, kk)
        store.delete("keys", kk)
        # deleting a live hsync stream: fence its writer first
        stale_writer = info.get("hsync_client_id")
        if stale_writer:
            store.delete("open_keys", f"{kk}/{stale_writer}")
        erase_gdpr_secret(info)
        store.put("deleted_keys", f"{kk}:{self.ts}", info)
        check_and_charge_quota(store, self.volume, self.bucket,
                               -int(info.get("size", 0)), -1)
        return info


@dataclass
class RenameKey(OMRequest):
    """Rename an OBS or LEGACY key: the row moves to the new name. On a
    LEGACY bucket (`fs_paths`) the destination obeys the filesystem shape
    (conflict checks, parent markers), as OpenKey and CommitKey do."""

    volume: str
    bucket: str
    key: str
    new_key: str
    fs_paths: bool = False
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        src = key_key(self.volume, self.bucket, self.key)
        info = store.get("keys", src)
        if info is None:
            raise OMError(KEY_NOT_FOUND, src)
        dst = key_key(self.volume, self.bucket, self.new_key)
        if self.fs_paths:
            check_fs_conflicts(store, self.volume, self.bucket,
                               self.new_key)
            markers = missing_parent_markers(store, self.volume,
                                             self.bucket, self.new_key)
            if markers:
                check_and_charge_quota(store, self.volume, self.bucket,
                                       0, len(markers))
                put_parent_markers(store, self.volume, self.bucket,
                                   markers, info.get("replication", ""),
                                   self.ts or time.time())
        # both ends change: the source row goes, the destination row is
        # created or overwritten
        preserve_preimage(store, self.volume, self.bucket, src)
        preserve_preimage(store, self.volume, self.bucket, dst)
        info["name"] = self.new_key
        store.delete("keys", src)
        store.put("keys", dst, info)


@dataclass
class RecoverLease(OMRequest):
    """Seal an abandoned hsynced write (the ozonefs adapter's recoverLease):
    the key stays at its last synced length, every open session of it is
    dropped, and so the dead writer's next hsync or commit fails on the
    missing session. OBS keys and FSO files alike (the path resolves
    against the bucket's layout)."""

    volume: str
    bucket: str
    key: str
    modified: float = 0.0

    def pre_execute(self, om) -> None:
        self.modified = time.time()

    def apply(self, store):
        from ozone_tpu_torch.om import fso

        b = store.get("buckets", bucket_key(self.volume, self.bucket))
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, f"{self.volume}/{self.bucket}")
        if b.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            parent_id, name = fso.resolve_parent(store, self.volume,
                                                 self.bucket, self.key)
            ek = fso.dir_key(self.volume, self.bucket, parent_id, name)
            table = "files"
        else:
            ek = key_key(self.volume, self.bucket, self.key)
            table = "keys"
        cur = store.get(table, ek)
        sessions = direct_sessions_of(store, ek)
        for s in sessions:
            store.delete("open_keys", s)
        if cur is not None:
            if table == "keys":
                preserve_preimage(store, self.volume, self.bucket, ek)
            else:
                preserve_fso_preimage(store, self.volume, self.bucket,
                                      "files", ek)
            if cur.pop("hsync_client_id", None) is not None:
                cur["modified"] = self.modified
                store.put(table, ek, cur)
            return {"recovered": True, "key": cur}
        if sessions:
            # never hsynced: nothing visible to seal; the uncommitted
            # chunks are left unreferenced on the datanodes
            return {"recovered": False, "key": None}
        raise OMError(KEY_NOT_FOUND,
                      f"{self.volume}/{self.bucket}/{self.key}")


@dataclass
class SetBucketAttrs(OMRequest):
    """Merge filesystem attributes onto the bucket row: ofs shows
    /volume/bucket as a directory, so chmod or chown of a mount's top
    level lands here. None values delete."""

    volume: str
    bucket: str
    attrs: dict = field(default_factory=dict)

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        merged = dict(b.get("attrs", {}))
        for key, v in self.attrs.items():
            if v is None:
                merged.pop(key, None)
            else:
                merged[key] = v
        b["attrs"] = merged
        store.put("buckets", k, b)
        return b


@dataclass
class PurgeDeletedKeys(OMRequest):
    """Remove processed entries from the deleted table (the key-deleting
    service's completion)."""

    entries: list[str] = field(default_factory=list)

    def apply(self, store):
        for k in self.entries:
            store.delete("deleted_keys", k)


def check_attr_preconds(info: dict, preconds: dict) -> None:
    """Attribute flags, checked inside the serialized apply: True = the
    attribute must exist, False = it must not."""
    have = info.get("attrs", {})
    for name, must_exist in (preconds or {}).items():
        if must_exist and name not in have:
            raise OMError("XATTR_NOT_FOUND", name)
        if not must_exist and name in have:
            raise OMError("XATTR_EXISTS", name)


@dataclass
class SetKeyAttrs(OMRequest):
    """Merge attributes into a key or directory-marker row (S3 object
    tags, filesystem owner and times). A None value deletes the
    attribute; `preconds` maps attribute -> must-exist."""

    volume: str
    bucket: str
    key: str
    attrs: dict
    preconds: dict = field(default_factory=dict)

    def apply(self, store):
        kk = key_key(self.volume, self.bucket, self.key)
        info = store.get("keys", kk)
        if info is None:  # directory marker
            kk = key_key(self.volume, self.bucket, self.key + "/")
            info = store.get("keys", kk)
        if info is None:
            raise OMError(KEY_NOT_FOUND, kk)
        preserve_preimage(store, self.volume, self.bucket, kk)
        check_attr_preconds(info, self.preconds)
        merged = dict(info.get("attrs", {}))
        for k, v in self.attrs.items():
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        info["attrs"] = merged
        store.put("keys", kk, info)
        return info


@dataclass
class SetS3Secret(OMRequest):
    """Store an access id's S3 secret. With if_absent the get-or-create
    is atomic inside apply, so concurrent first fetches converge on one
    secret."""

    access_id: str
    secret: str
    if_absent: bool = False

    def apply(self, store):
        if self.if_absent:
            row = store.get("s3_secrets", self.access_id)
            if row is not None:
                return row["secret"]
        store.put("s3_secrets", self.access_id,
                  {"access_id": self.access_id, "secret": self.secret})
        return self.secret


@dataclass
class RevokeS3Secret(OMRequest):
    access_id: str

    def apply(self, store):
        store.delete("s3_secrets", self.access_id)


# ----------------------------------------------------------- small objects
def check_smallobj_bucket(b: dict) -> None:
    """Small-object eligibility, shared by the opt-in verb and the
    applies: inline values and needle packing need a flat key table and
    no per-key DEK. Refused with a typed error at config or PUT time,
    never mid-flush. (The port serves no FSO bucket; the FSO refusal
    answers the reference's code for a row the reference wrote.)"""
    if b.get("layout") == "FILE_SYSTEM_OPTIMIZED":
        raise OMError(
            SMALLOBJ_NOT_SUPPORTED,
            f"/{b.get('volume')}/{b.get('name')} is FILE_SYSTEM_OPTIMIZED"
            " — inline/needle packing needs a flat key table")
    if b.get("encryption_key") or b.get("gdpr"):
        raise OMError(
            SMALLOBJ_NOT_SUPPORTED,
            f"/{b.get('volume')}/{b.get('name')} is encrypted — small-"
            "object commits mint no per-key DEK")
    if b.get("source"):
        raise OMError(
            SMALLOBJ_NOT_SUPPORTED,
            "configure small objects on the link SOURCE bucket")


@dataclass
class SetBucketSmallObj(OMRequest):
    """Opt a bucket into (or out of) the small-object path: keys at or
    under `inline_max` bytes ride the key row, keys at or under
    `needle_max` the slab packer. Zeros defer to the env knobs at read
    time (`client/slab.smallobj_conf`)."""

    volume: str
    bucket: str
    enabled: bool = True
    inline_max: int = 0
    needle_max: int = 0

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        if not self.enabled:
            b.pop("smallobj", None)
        else:
            check_smallobj_bucket(b)
            if self.inline_max and self.needle_max and \
                    self.inline_max > self.needle_max:
                raise OMError(
                    INVALID_REQUEST,
                    f"inline_max {self.inline_max} > needle_max "
                    f"{self.needle_max}")
            b["smallobj"] = {"inline_max": int(self.inline_max),
                             "needle_max": int(self.needle_max)}
        store.put("buckets", k, b)
        return b


@dataclass
class PutInlineKey(OMRequest):
    """A tiny PUT as one request: open, data and commit fused, the value
    riding the key row itself (base64). No blocks: a GET is served from
    the OM alone."""

    volume: str
    bucket: str
    key: str
    data: str = ""  # base64, bounded by the bucket's inline_max
    size: int = 0
    metadata: dict = field(default_factory=dict)
    modified: float = 0.0
    key_id: str = ""
    #: rewrite fence, as CommitKey's ("" = plain overwrite)
    expect_object_id: str = ""
    expect_generation: int = -1

    def pre_execute(self, om) -> None:
        self.modified = time.time()
        self.key_id = uuid.uuid4().hex[:16]

    def apply(self, store):
        from ozone_tpu_torch.om.acl import inherit_defaults

        b = store.get("buckets", bucket_key(self.volume, self.bucket))
        if b is None:
            raise OMError(BUCKET_NOT_FOUND,
                          f"{self.volume}/{self.bucket}")
        check_smallobj_bucket(b)
        kk = key_key(self.volume, self.bucket, self.key)
        old = store.get("keys", kk)
        if self.expect_object_id and not (
                old is not None
                and old.get("object_id") == self.expect_object_id
                and (self.expect_generation < 0
                     or int(old.get("generation", 0))
                     == self.expect_generation)):
            raise OMError(KEY_MODIFIED,
                          f"{kk} changed during inline rewrite")
        info = {
            "volume": self.volume,
            "bucket": self.bucket,
            "name": self.key,
            "object_id": self.key_id,
            "replication": "inline",
            "checksum_type": "CRC32C",
            "size": int(self.size),
            "block_groups": [],
            "inline": self.data,
            "created": self.modified,
            "modified": self.modified,
            "acls": inherit_defaults(b.get("acls", [])),
        }
        if self.metadata:
            info["metadata"] = dict(self.metadata)
        finalize_commit(store, "keys", kk, info, old, "", False,
                        self.modified)
        return info


@dataclass
class CommitKeys(OMRequest):
    """Batched needle commit: N tiny keys land in one request, each a
    needle (slab_id, offset, length, crc) into a freshly sealed slab
    whose block groups ride the same apply. A fenced entry whose live row
    moved, or one superseded later in the batch, is skipped (its bytes
    are born dead in the slab), not the batch aborted. The batch is
    all-or-nothing: every precondition (bucket, slab uniqueness,
    aggregate quota) is checked before the first mutation."""

    volume: str
    bucket: str
    slab: dict = field(default_factory=dict)
    entries: list = field(default_factory=list)
    modified: float = 0.0
    key_ids: list = field(default_factory=list)

    def pre_execute(self, om) -> None:
        self.modified = time.time()
        self.key_ids = [uuid.uuid4().hex[:16] for _ in self.entries]

    def apply(self, store):  # noqa: C901 - one validate+mutate pass
        from ozone_tpu_torch.om.acl import inherit_defaults

        bk = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", bk)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, bk)
        check_smallobj_bucket(b)
        sid = self.slab.get("slab_id", "")
        if not sid or not self.slab.get("block_groups"):
            raise OMError(INVALID_REQUEST, "slab id/groups missing")
        sk = slab_key(self.volume, self.bucket, sid)
        if store.exists("slabs", sk):
            raise OMError(INVALID_REQUEST,
                          f"slab {sid} already sealed")
        # validation pass: fences and the aggregate quota, no mutation
        last: dict = {}  # key -> entry index (duplicates: last wins)
        for i, e in enumerate(self.entries):
            last[e["key"]] = i
        live, skipped = [], []
        dead_bytes, bytes_delta, keys_delta = 0, 0, 0
        for i, e in enumerate(self.entries):
            key = e["key"]
            if last[key] != i:
                skipped.append(key)  # superseded within the batch
                dead_bytes += int(e["length"])
                continue
            old = store.get("keys",
                            key_key(self.volume, self.bucket, key))
            fence = e.get("expect_object_id", "")
            gen = int(e.get("expect_generation", -1))
            if fence and not (
                    old is not None
                    and old.get("object_id") == fence
                    and (gen < 0
                         or int(old.get("generation", 0)) == gen)):
                skipped.append(key)  # fenced out: its bytes go dead
                dead_bytes += int(e["length"])
                continue
            bytes_delta += int(e["length"]) - (
                int(old.get("size", 0)) if old is not None else 0)
            keys_delta += 0 if old is not None else 1
            live.append((i, e, old))
        check_and_charge_quota(store, self.volume, self.bucket,
                               bytes_delta, keys_delta)
        # mutation pass: cannot fail past this point
        default_acls = inherit_defaults(b.get("acls", []))
        needles: dict = {}
        committed = []
        for i, e, old in live:
            key = e["key"]
            kk = key_key(self.volume, self.bucket, key)
            info = {
                "volume": self.volume,
                "bucket": self.bucket,
                "name": key,
                "object_id": self.key_ids[i],
                "replication": self.slab.get("replication", ""),
                "checksum_type": "CRC32C",
                "size": int(e["length"]),
                "block_groups": [],
                "needle": {"slab": sid, "offset": int(e["offset"]),
                           "length": int(e["length"]),
                           "crc": int(e["crc"])},
                "created": self.modified,
                "modified": self.modified,
                "acls": e.get("acls") or default_acls,
            }
            if e.get("metadata"):
                info["metadata"] = dict(e["metadata"])
            preserve_preimage(store, self.volume, self.bucket, kk)
            info["generation"] = (int(old.get("generation", 0)) + 1
                                  if old is not None else 1)
            if old is not None and (old.get("block_groups")
                                    or old.get("needle")):
                stale_writer = old.get("hsync_client_id")
                if stale_writer:
                    store.delete("open_keys", f"{kk}/{stale_writer}")
                erase_gdpr_secret(old)
                store.put("deleted_keys", f"{kk}:{self.modified}", old)
            store.put("keys", kk, info)
            needles[key] = {"off": int(e["offset"]),
                            "len": int(e["length"]),
                            "oid": self.key_ids[i]}
            committed.append(key)
        store.put("slabs", sk, {
            "slab_id": sid,
            "volume": self.volume,
            "bucket": self.bucket,
            "replication": self.slab.get("replication", ""),
            "length": int(self.slab.get("length", 0)),
            "block_groups": list(self.slab.get("block_groups", [])),
            "needles": needles,
            "dead_bytes": dead_bytes,
            "dead_count": len(skipped),
            "created": self.modified,
        })
        return {"slab_id": sid, "committed": committed,
                "skipped": skipped}


@dataclass
class AccountDeadNeedles(OMRequest):
    """A purged needle version hands its bytes back to its slab's dead
    counters (the shared slab blocks are not the purge chain's to free).
    Against a retired slab it is a no-op."""

    volume: str
    bucket: str
    slab_id: str
    count: int = 0
    nbytes: int = 0

    def apply(self, store):
        sk = slab_key(self.volume, self.bucket, self.slab_id)
        row = store.get("slabs", sk)
        if row is None:
            return None  # slab already compacted away
        row["dead_count"] = int(row.get("dead_count", 0)) + self.count
        row["dead_bytes"] = int(row.get("dead_bytes", 0)) + self.nbytes
        store.put("slabs", sk, row)
        return row


@dataclass
class RetireSlab(OMRequest):
    """Drop a compacted slab's directory row. The caller releases the
    slab's blocks to the SCM's deletion log after this commits: blocks
    outliving metadata is safe, the reverse is data loss."""

    volume: str
    bucket: str
    slab_id: str

    def apply(self, store):
        sk = slab_key(self.volume, self.bucket, self.slab_id)
        row = store.get("slabs", sk)
        if row is None:
            raise OMError(KEY_NOT_FOUND, f"slab {sk}")
        store.delete("slabs", sk)
        return row


# ------------------------------------------------------- bucket lifecycle
@dataclass
class SetBucketLifecycle(OMRequest):
    """Install a bucket's lifecycle rules (the S3
    PutBucketLifecycleConfiguration analog); they ride the bucket row."""

    volume: str
    bucket: str
    rules: list = field(default_factory=list)

    def pre_execute(self, om) -> None:
        from ozone_tpu_torch.lifecycle.policy import (
            LifecycleError,
            validate_rules,
        )

        try:
            self.rules = validate_rules(self.rules)
        except LifecycleError as e:
            raise OMError(INVALID_REQUEST, str(e))

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        if b.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            # the sweeper's prefix rules walk the flat key table
            raise OMError(
                INVALID_REQUEST,
                "lifecycle rules are not supported on "
                "FILE_SYSTEM_OPTIMIZED buckets")
        b["lifecycle"] = list(self.rules)
        store.put("buckets", k, b)
        return b


@dataclass
class DeleteBucketLifecycle(OMRequest):
    volume: str
    bucket: str

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        b.pop("lifecycle", None)
        store.put("buckets", k, b)
        return b


@dataclass
class LifecycleCheckpoint(OMRequest):
    """The sweeper's state: fencing term and resumable cursor. A `fence`
    checkpoint claims the sweeper role for `term` and is refused when a
    higher term already holds it; a plain checkpoint is refused unless
    its term is the fenced one. A deposed sweeper's late cursor can
    never regress the scan."""

    term: int
    cursor: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    fence: bool = False

    def apply(self, store):
        row = store.get("system", "lifecycle_state") or {"term": -1}
        fenced = int(row.get("term", -1))
        if self.fence:
            if int(self.term) < fenced:
                raise OMError(
                    LIFECYCLE_FENCED,
                    f"fence term {self.term} < current {fenced}")
            row["term"] = int(self.term)
        else:
            if int(self.term) != fenced:
                raise OMError(
                    LIFECYCLE_FENCED,
                    f"checkpoint term {self.term} != fenced {fenced}")
            row["cursor"] = dict(self.cursor)
            if self.stats:
                row["stats"] = dict(self.stats)
        store.put("system", "lifecycle_state", row)
        return dict(row)


@dataclass
class SetBucketAcl(OMRequest):
    """Replace a bucket's ACL grant list (reference: OMBucketSetAclRequest;
    S3 grants map onto the bucket record)."""

    volume: str
    bucket: str
    acl: list[dict] = field(default_factory=list)

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        b["acl"] = self.acl
        store.put("buckets", k, b)



# ------------------------------------------------------ native ACLs, tenants
_OBJ_TABLES = {"volume": "volumes", "bucket": "buckets", "key": "keys"}


def _acl_target(store, obj_type: str, volume: str, bucket: str, path: str):
    """(table, row_key) for an ACL object; prefix rows are created on
    demand (the reference's prefixTable upserts). Keys resolve through
    the flat table for OBS buckets and the parent-id-keyed file table for
    FSO buckets (reference: BucketLayoutAwareOMKeyRequestFactory)."""
    from ozone_tpu_torch.om import acl as aclmod

    if obj_type == "volume":
        return "volumes", volume_key(volume)
    if obj_type == "bucket":
        return "buckets", bucket_key(volume, bucket)
    if obj_type == "key":
        flat = f"/{volume}/{bucket}/{path}"
        if store.exists("keys", flat):
            return "keys", flat
        b = store.get("buckets", bucket_key(volume, bucket))
        if b is not None and b.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            from ozone_tpu_torch.om import fso

            try:
                parent_id, name = fso.resolve_parent(store, volume, bucket,
                                                     path)
            except OMError:
                return "keys", flat  # unreachable path -> KEY_NOT_FOUND
            fk = fso.dir_key(volume, bucket, parent_id, name)
            if store.exists("files", fk):
                return "files", fk
        return "keys", flat
    if obj_type == "prefix":
        return "prefixes", aclmod.prefix_key(volume, bucket, path)
    raise OMError(INVALID_REQUEST, f"unknown acl object type {obj_type}")


@dataclass
class ModifyAcl(OMRequest):
    """Add/remove/replace native ACL grants on volume/bucket/key/prefix
    (reference: OM*AddAclRequest / *RemoveAclRequest / *SetAclRequest
    families + OMPrefixAclRequest)."""

    obj_type: str  # volume | bucket | key | prefix
    volume: str
    bucket: str = ""
    path: str = ""
    op: str = "add"  # add | remove | set
    acls: list[dict] = field(default_factory=list)

    def apply(self, store):
        from ozone_tpu_torch.om import acl as aclmod

        if self.op not in ("add", "remove", "set"):
            raise OMError(INVALID_REQUEST, f"unknown acl op {self.op!r}")
        table, k = _acl_target(store, self.obj_type, self.volume,
                               self.bucket, self.path)
        row = store.get(table, k)
        if row is None:
            if table == "prefixes":
                row = {"acls": []}
            else:
                raise OMError(
                    {"volumes": VOLUME_NOT_FOUND,
                     "buckets": BUCKET_NOT_FOUND,
                     "keys": KEY_NOT_FOUND,
                     "files": KEY_NOT_FOUND}[table], k)
        elif table == "keys":
            preserve_preimage(store, self.volume, self.bucket, k)
        elif table == "files":
            preserve_fso_preimage(store, self.volume, self.bucket,
                                  "files", k)
        existing = row.get("acls", [])
        changed = False
        if self.op == "set":
            row["acls"] = list(self.acls)
            changed = True
        else:
            fn = aclmod.add_acl if self.op == "add" else aclmod.remove_acl
            for d in self.acls:
                existing, ch = fn(existing, aclmod.OzoneAcl.from_json(d))
                changed = changed or ch
            row["acls"] = existing
        if changed:
            store.put(table, k, row)
        return changed


@dataclass
class CreateTenant(OMRequest):
    """Create a tenant backed by its own volume (reference:
    OMTenantCreateRequest — tenant name == volume unless overridden)."""

    tenant: str
    volume: str = ""
    owner: str = "root"
    created: float = 0.0

    def pre_execute(self, om) -> None:
        self.created = time.time()
        if not self.volume:
            self.volume = self.tenant

    def apply(self, store):
        if store.exists("tenants", self.tenant):
            raise OMError(TENANT_ALREADY_EXISTS, self.tenant)
        vk = volume_key(self.volume)
        # the tenant volume must be fresh: adopting an existing volume
        # (s3v, another owner's namespace) would hand the tenant's users
        # its entire contents (reference OMTenantCreateRequest fails the
        # same way)
        if store.exists("volumes", vk):
            raise OMError(VOLUME_ALREADY_EXISTS,
                          f"tenant volume {self.volume} already exists")
        store.put("volumes", vk, {
            "name": self.volume,
            "owner": self.owner,
            "quota_bytes": -1,
            "created": self.created,
        })
        store.put("tenants", self.tenant, {
            "tenant": self.tenant,
            "volume": self.volume,
            "created": self.created,
        })


@dataclass
class DeleteTenant(OMRequest):
    tenant: str

    def apply(self, store):
        if not store.exists("tenants", self.tenant):
            raise OMError(TENANT_NOT_FOUND, self.tenant)
        for _, row in store.iterate("tenant_access"):
            if row["tenant"] == self.tenant:
                raise OMError(TENANT_NOT_EMPTY,
                              f"{self.tenant} still has access ids")
        store.delete("tenants", self.tenant)


@dataclass
class AssignUserToTenant(OMRequest):
    """Grant a user an S3 access id under a tenant (reference:
    OMTenantAssignUserAccessIdRequest: accessId = tenant$user, S3 secret
    minted and stored)."""

    tenant: str
    user: str
    access_id: str = ""
    secret: str = ""

    def pre_execute(self, om) -> None:
        import secrets as _secrets

        if not self.access_id:
            self.access_id = f"{self.tenant}${self.user}"
        if not self.secret:
            self.secret = _secrets.token_hex(20)

    def apply(self, store):
        if not store.exists("tenants", self.tenant):
            raise OMError(TENANT_NOT_FOUND, self.tenant)
        # never adopt or rotate an existing identity: that would silently
        # invalidate issued credentials or re-point another tenant's
        # access id here (reference: TENANT_ACCESS_ID_ALREADY_EXISTS)
        if store.exists("tenant_access", self.access_id) or \
                store.exists("s3_secrets", self.access_id):
            raise OMError(ACCESS_ID_ALREADY_EXISTS, self.access_id)
        store.put("tenant_access", self.access_id, {
            "access_id": self.access_id,
            "tenant": self.tenant,
            "user": self.user,
        })
        store.put("s3_secrets", self.access_id, {
            "access_id": self.access_id,
            "secret": self.secret,
        })
        return {"access_id": self.access_id, "secret": self.secret}


@dataclass
class RevokeUserAccessId(OMRequest):
    access_id: str

    def apply(self, store):
        if not store.exists("tenant_access", self.access_id):
            raise OMError(ACCESS_ID_NOT_FOUND, self.access_id)
        store.delete("tenant_access", self.access_id)
        store.delete("s3_secrets", self.access_id)


# ---------------------------------------------------- delegation tokens
@dataclass
class NewDTokenMasterKey(OMRequest):
    """Install a delegation-token master key (reference: the
    OzoneDelegationTokenSecretManager rolling its master key and
    persisting it through OMUpdateDelegationTokenRequest so every HA
    replica signs/verifies identically). The leader mints material in
    pre_execute; apply installs it verbatim — deterministic on replicas."""

    key_id: str = ""
    material: str = ""
    created: float = 0.0
    expires: float = 0.0
    if_absent: bool = True

    def pre_execute(self, om) -> None:
        import secrets as _secrets

        self.key_id = _secrets.token_hex(8)
        self.material = _secrets.token_bytes(32).hex()
        self.created = time.time()
        self.expires = self.created + om.dtoken_key_lifetime_s

    def apply(self, store):
        from ozone_tpu_torch.om import dtokens

        if self.if_absent:
            cur = dtokens.current_key(store, now=self.created)
            if cur is not None:
                return cur["key_id"]
        store.put("dtoken_keys", self.key_id, {
            "key_id": self.key_id,
            "material": self.material,
            "created": self.created,
            "expires": self.expires,
        })
        return self.key_id


@dataclass
class StoreDelegationToken(OMRequest):
    """Persist an issued token's server-side row (the dTokenTable write
    in OMGetDelegationTokenRequest.validateAndUpdateCache)."""

    ident: dict = field(default_factory=dict)
    expiry: float = 0.0

    def apply(self, store):
        row = dict(self.ident)
        row.pop("sig", None)
        row["expiry"] = self.expiry
        store.put("delegation_tokens", str(self.ident["token_id"]), row)
        return row


@dataclass
class RenewDelegationToken(OMRequest):
    """Extend a token's renewable expiry, bounded by its max_date
    (OMRenewDelegationTokenRequest; only the named renewer may renew)."""

    token_id: str
    requester: str
    now: float = 0.0
    renew_interval_s: float = 86400.0

    def pre_execute(self, om) -> None:
        self.now = time.time()
        self.renew_interval_s = om.dtoken_renew_interval_s

    def apply(self, store):
        row = store.get("delegation_tokens", self.token_id)
        if row is None:
            raise OMError(TOKEN_ERROR, "token cancelled or unknown")
        if self.requester != row["renewer"]:
            raise OMError(
                TOKEN_ERROR,
                f"{self.requester!r} is not the renewer ({row['renewer']!r})")
        if row["expiry"] < self.now:
            raise OMError(TOKEN_ERROR, "token expired; cannot renew")
        row["expiry"] = round(min(self.now + self.renew_interval_s,
                                  row["max_date"]), 3)
        store.put("delegation_tokens", self.token_id, row)
        return row["expiry"]


@dataclass
class CancelDelegationToken(OMRequest):
    """Invalidate a token (OMCancelDelegationTokenRequest; owner or
    renewer only)."""

    token_id: str
    requester: str

    def apply(self, store):
        row = store.get("delegation_tokens", self.token_id)
        if row is None:
            raise OMError(TOKEN_ERROR, "token cancelled or unknown")
        if self.requester not in (row["owner"], row["renewer"]):
            raise OMError(
                TOKEN_ERROR,
                f"{self.requester!r} is neither owner nor renewer")
        store.delete("delegation_tokens", self.token_id)


@dataclass
class PurgeExpiredDTokens(OMRequest):
    """Background sweep: drop tokens past expiry and master keys that are
    both expired and unreferenced (the reference's ExpiredTokenRemover
    thread inside OzoneDelegationTokenSecretManager)."""

    now: float = 0.0

    def pre_execute(self, om) -> None:
        if not self.now:
            self.now = time.time()

    def apply(self, store):
        dropped = 0
        live_keys = set()
        for tid, row in list(store.iterate("delegation_tokens")):
            if min(row["expiry"], row["max_date"]) < self.now:
                store.delete("delegation_tokens", tid)
                dropped += 1
            else:
                live_keys.add(row["key_id"])
        for kid, row in list(store.iterate("dtoken_keys")):
            if row["expires"] < self.now and kid not in live_keys:
                store.delete("dtoken_keys", kid)
        return dropped


@dataclass
class CreateMasterKey(OMRequest):
    """Mint (or rotate) a named KMS master key. The material is made in
    pre_execute on the leader and replicates through the log, so every
    replica can unwrap EDEKs (the metadata ring is the key authority)."""

    name: str
    rotate: bool = False
    material: str = ""

    def pre_execute(self, om) -> None:
        import os

        self.material = os.urandom(32).hex()

    def apply(self, store):
        from ozone_tpu_torch.utils.kms import MASTER_PREFIX

        k = MASTER_PREFIX + self.name
        row = store.get("system", k)
        if row is None:
            if self.rotate:
                raise OMError(INVALID_REQUEST,
                              f"no master key {self.name!r} to rotate")
            row = {"versions": []}
        elif not self.rotate:
            raise OMError(INVALID_REQUEST,
                          f"master key {self.name!r} exists")
        row["versions"].append(self.material)
        store.put("system", k, row)
        return {"name": self.name, "versions": len(row["versions"])}


# ------------------------------------------------------------- snapshots
def snap_prefix(volume: str, bucket: str, snap_id: str) -> str:
    """Key-table prefix of a snapshot's rows (its overlay, or all of a
    materialized snapshot's rows): the one definition, shared by the
    write side here and the read side in `om/snapshots.py`."""
    return f"/.snapshot/{volume}/{bucket}/{snap_id}"


def snapmeta_key(volume: str, bucket: str, name: str) -> str:
    """open_keys row holding a snapshot's chain metadata."""
    return f"/.snapmeta/{volume}/{bucket}/{name}"


#: overlay row meaning "this key did not exist when the snapshot was
#: taken": a key created after a snapshot must not leak into its reads
#: through the fall-through to the live table
ABSENT = {"__absent__": True}

#: tells "resolve the newest snapshot yourself" from an explicit None
#: (the bucket has no snapshots)
_UNRESOLVED = object()


def is_absent_marker(row: Optional[dict]) -> bool:
    return bool(row) and row.get("__absent__") is True


def bucket_snapshots(store, volume: str, bucket: str) -> list[dict]:
    """This bucket's snapshot chain, oldest first."""
    out = [v for _, v in store.iterate(
        "open_keys", f"/.snapmeta/{volume}/{bucket}/")]
    out.sort(key=lambda v: v["created"])
    return out


def newest_snapshot(store, volume: str, bucket: str) -> Optional[dict]:
    """The bucket's newest snapshot in one pass (a bucket without
    snapshots pays one empty indexed scan)."""
    newest = None
    for _, v in store.iterate("open_keys",
                              f"/.snapmeta/{volume}/{bucket}/"):
        if newest is None or v["created"] > newest["created"]:
            newest = v
    return newest


def preserve_preimage(store, volume: str, bucket: str,
                      full_key: str) -> None:
    """Copy-on-write preservation of an OBS or LEGACY key row; call it
    before mutating or deleting the live row `full_key`. When the
    bucket's newest snapshot is copy-on-write and has no overlay entry
    for the key yet, the current live row (or an ABSENT marker) is
    recorded there. Reads resolve the value at snapshot S as the oldest
    overlay entry among the snapshots >= S, else the live row: a
    snapshot with no entry proves the key was not mutated in its reign."""
    base = bucket_key(volume, bucket) + "/"
    _preserve_row(store, volume, bucket, "keys", full_key,
                  full_key[len(base):])


def preserve_fso_preimage(store, volume: str, bucket: str, table: str,
                          storage_key: str, newest=_UNRESOLVED) -> None:
    """Copy-on-write preservation of an FSO row (dirs, files, dir_ids):
    the overlay key carries the table and the id-keyed storage key
    (`#table#key`), since FSO paths change under a one-row directory
    rename; reads walk the tree as of the snapshot through
    `snapshots.SnapshotStoreView`. An apply touching many rows resolves
    `newest` once and passes it in."""
    _preserve_row(store, volume, bucket, table, storage_key,
                  f"#{table}#{storage_key}", newest=newest)


def _preserve_row(store, volume: str, bucket: str, table: str,
                  storage_key: str, rel: str, newest=_UNRESOLVED) -> None:
    if newest is _UNRESOLVED:
        newest = newest_snapshot(store, volume, bucket)
    if newest is None or not newest.get("cow"):
        return
    ok = f"{snap_prefix(volume, bucket, newest['snap_id'])}/{rel}"
    if store.get("keys", ok) is not None:
        return  # already captured for this snapshot
    old = store.get(table, storage_key)
    if old is not None:
        # a deep copy: the fetched dict is the live cache row, which the
        # calling apply mutates next (a GDPR erase among others)
        old = json.loads(json.dumps(old))
    # derived rows stay out of the journal the incremental diff reads
    store.put("keys", ok, old if old is not None else dict(ABSENT),
              journal=False)


def is_snapmeta(open_key: str) -> bool:
    """True for the snapshot chain's rows in open_keys: every open-key
    scan skips them."""
    return open_key.startswith("/.snapmeta/")


SNAPSHOT_NOT_FOUND = "SNAPSHOT_NOT_FOUND"
SNAPSHOT_EXISTS = "SNAPSHOT_EXISTS"
INVALID_SNAPSHOT_NAME = "INVALID_SNAPSHOT_NAME"


@dataclass
class CreateSnapshot(OMRequest):
    """Bucket snapshot, chained to the bucket's previous one. Every new
    snapshot is copy-on-write: the apply writes only the chain row
    (O(#snapshots)), and the overlay fills as the pre-image sites capture
    each first mutation while it is newest. OBS and LEGACY overlays are
    path-keyed, FSO overlays id-keyed (`#table#key`)."""

    volume: str
    bucket: str
    name: str
    snap_id: str = ""
    created: float = 0.0

    def pre_execute(self, om) -> None:
        self.snap_id = uuid.uuid4().hex[:12]
        self.created = time.time()

    def apply(self, store):
        if not self.name or "/" in self.name:
            # names ride the .snapshot/<name>/<key> path and the snapmeta
            # key space: an empty or slashed name is unaddressable
            raise OMError(INVALID_SNAPSHOT_NAME, repr(self.name))
        brow = store.get("buckets", bucket_key(self.volume, self.bucket))
        if brow is None:
            raise OMError(BUCKET_NOT_FOUND, f"{self.volume}/{self.bucket}")
        meta_key = snapmeta_key(self.volume, self.bucket, self.name)
        if store.exists("open_keys", meta_key):
            raise OMError(SNAPSHOT_EXISTS, self.name)
        prev = newest_snapshot(store, self.volume, self.bucket)
        info = {
            "volume": self.volume,
            "bucket": self.bucket,
            "name": self.name,
            "snap_id": self.snap_id,
            "created": self.created,
            "previous": prev["snap_id"] if prev is not None else None,
            "cow": True,
        }
        if brow.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            info["fso"] = True
        store.put("open_keys", meta_key, info)
        # this replica's journal position: the diff then walks only the
        # updates between two snapshots
        store.snapshot_markers[self.snap_id] = store.txid
        return info


@dataclass
class DeleteSnapshot(OMRequest):
    """Drop a snapshot's rows and chain row. A copy-on-write snapshot
    first merges its overlay down into the adjacent older snapshot when
    that one is copy-on-write too (an entry kept here may be the truth for
    reads at older snapshots that saw no mutation of the key); a
    materialized older snapshot is complete already. O(overlay)."""

    volume: str
    bucket: str
    name: str

    def apply(self, store):
        meta_key = snapmeta_key(self.volume, self.bucket, self.name)
        info = store.get("open_keys", meta_key)
        if info is None:
            raise OMError(SNAPSHOT_NOT_FOUND, self.name)
        prefix = snap_prefix(self.volume, self.bucket, info["snap_id"])
        if info.get("cow"):
            snaps = bucket_snapshots(store, self.volume, self.bucket)
            idx = next(i for i, s in enumerate(snaps)
                       if s["snap_id"] == info["snap_id"])
            older = snaps[idx - 1] if idx > 0 else None
            if older is not None and older.get("cow"):
                op = snap_prefix(self.volume, self.bucket, older["snap_id"])
                for k, v in list(store.iterate("keys", prefix + "/")):
                    rel = k[len(prefix) + 1:]
                    if store.get("keys", f"{op}/{rel}") is None:
                        store.put("keys", f"{op}/{rel}", v, journal=False)
        for k, _ in list(store.iterate("keys", prefix)):
            store.delete("keys", k, journal=False)
        store.delete("open_keys", meta_key)
        store.snapshot_markers.pop(info["snap_id"], None)
        return info


@dataclass
class RenameSnapshot(OMRequest):
    """Rename a snapshot: its rows and journal marker are keyed by
    snap_id, so only the name-keyed chain row moves."""

    volume: str
    bucket: str
    name: str
    new_name: str

    def apply(self, store):
        if not self.new_name or "/" in self.new_name:
            raise OMError(INVALID_SNAPSHOT_NAME, repr(self.new_name))
        mk = snapmeta_key(self.volume, self.bucket, self.name)
        info = store.get("open_keys", mk)
        if info is None:
            raise OMError(SNAPSHOT_NOT_FOUND, self.name)
        nk = snapmeta_key(self.volume, self.bucket, self.new_name)
        if store.exists("open_keys", nk):
            raise OMError(SNAPSHOT_EXISTS, self.new_name)
        info["name"] = self.new_name
        store.delete("open_keys", mk)
        store.put("open_keys", nk, info)
        return info


# ------------------------------------------- quotas, owner, replication
@dataclass
class SetQuota(OMRequest):
    """Space and namespace quota of a volume (bucket "") or a bucket. None
    leaves a dimension as it is; -1 clears it to unlimited."""

    volume: str
    bucket: str = ""
    quota_bytes: Optional[int] = None
    quota_namespace: Optional[int] = None

    def apply(self, store):
        if self.bucket:
            k, table = bucket_key(self.volume, self.bucket), "buckets"
            missing = BUCKET_NOT_FOUND
        else:
            k, table = volume_key(self.volume), "volumes"
            missing = VOLUME_NOT_FOUND
        row = store.get(table, k)
        if row is None:
            raise OMError(missing, k)
        if self.quota_bytes is not None:
            row["quota_bytes"] = int(self.quota_bytes)
        if self.quota_namespace is not None:
            row["quota_namespace"] = int(self.quota_namespace)
        store.put(table, k, row)
        return row


@dataclass
class SetVolumeOwner(OMRequest):
    """Transfer a volume's ownership (`sh volume update --user`)."""

    volume: str
    owner: str

    def pre_execute(self, om) -> None:
        if not self.owner:
            raise OMError(INVALID_REQUEST, "new owner must be non-empty")

    def apply(self, store):
        k = volume_key(self.volume)
        row = store.get("volumes", k)
        if row is None:
            raise OMError(VOLUME_NOT_FOUND, self.volume)
        row["owner"] = self.owner
        store.put("volumes", k, row)
        return row


@dataclass
class ApplyQuotaRepair(OMRequest):
    """Apply per-bucket usage deltas computed beforehand: the recount
    pages through the tables outside the apply (`OzoneManager.
    repair_quota`), and this apply touches one row per bucket plus the
    volume row. Deltas, not absolutes, so a key committed after its page
    was scanned keeps its own charge."""

    volume: str
    #: bucket_key -> [d_used_bytes, d_key_count]
    deltas: dict = None  # type: ignore[assignment]

    def apply(self, store):
        vk = volume_key(self.volume)
        vrow = store.get("volumes", vk)
        if vrow is None:
            raise OMError(VOLUME_NOT_FOUND, self.volume)
        out = {}
        for bk, (d_used, d_keys) in (self.deltas or {}).items():
            brow = store.get("buckets", bk)
            if brow is None:
                continue  # deleted between the scan and the apply
            brow["used_bytes"] = int(brow.get("used_bytes", 0)) + int(d_used)
            brow["key_count"] = int(brow.get("key_count", 0)) + int(d_keys)
            store.put("buckets", bk, brow)
            out[bk] = {"used_bytes": brow["used_bytes"],
                       "key_count": brow["key_count"]}
        # the volume's totals from the adjusted bucket rows: O(#buckets)
        vtotal = vkeys = 0
        for _, brow in store.iterate("buckets", f"/{self.volume}/"):
            vtotal += int(brow.get("used_bytes", 0))
            vkeys += int(brow.get("key_count", 0))
        vrow["used_bytes"] = vtotal
        vrow["key_count"] = vkeys
        store.put("volumes", vk, vrow)
        return {"volume_used_bytes": vtotal, "volume_key_count": vkeys,
                "buckets": out}


@dataclass
class SetBucketReplication(OMRequest):
    """Change a bucket's default replication: it applies to keys written
    after the change; existing keys keep theirs until rewritten."""

    volume: str
    bucket: str
    replication: str

    def pre_execute(self, om) -> None:
        from ozone_tpu_torch.scm.pipeline import ReplicationConfig

        ReplicationConfig.parse(self.replication)  # raises on nonsense

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        b["replication"] = self.replication
        store.put("buckets", k, b)
        return b


# ------------------------------------------------------- geo replication
@dataclass
class SetBucketGeoReplication(OMRequest):
    """Install a bucket's cross-cluster replication rules (the S3
    PutBucketReplication analog); they ride the bucket row, so they
    replicate and survive failover like every bucket property. The
    shipper (`replication_geo/shipper.py`) enforces them."""

    volume: str
    bucket: str
    rules: list = field(default_factory=list)

    def pre_execute(self, om) -> None:
        from ozone_tpu_torch.replication_geo.rules import (
            GeoReplicationError,
            validate_rules,
        )

        try:
            self.rules = validate_rules(self.rules)
        except GeoReplicationError as e:
            raise OMError(INVALID_REQUEST, str(e))

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        if b.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            # the shipper tails the flat key table; an FSO namespace
            # commits through the file table, so rules here would ship
            # nothing: refused, as lifecycle rules are
            raise OMError(
                INVALID_REQUEST,
                "geo replication rules are not supported on "
                "FILE_SYSTEM_OPTIMIZED buckets")
        b["geo_replication"] = list(self.rules)
        store.put("buckets", k, b)
        return b


@dataclass
class DeleteBucketGeoReplication(OMRequest):
    volume: str
    bucket: str

    def apply(self, store):
        k = bucket_key(self.volume, self.bucket)
        b = store.get("buckets", k)
        if b is None:
            raise OMError(BUCKET_NOT_FOUND, k)
        b.pop("geo_replication", None)
        store.put("buckets", k, b)
        return b


@dataclass
class GeoCheckpoint(OMRequest):
    """The shipper's state: fencing term, the journal cursor (the last
    shipped txid) and the buckets whose first reconcile finished,
    committed through the ring so a restarted or failed-over shipper
    resumes at the last durable page. A `fence` checkpoint claims the
    shipper role for `term` and is refused when a higher term holds it;
    a plain checkpoint is refused unless its term is the fenced one. A
    deposed shipper's late cursor can never regress the journal
    position."""

    term: int
    cursor: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    #: None = leave the bootstrapped-bucket set unchanged
    bootstrapped: Optional[list] = None
    fence: bool = False

    def apply(self, store):
        row = store.get("system", "geo_state") or {"term": -1}
        fenced = int(row.get("term", -1))
        if self.fence:
            if int(self.term) < fenced:
                raise OMError(
                    GEO_FENCED,
                    f"fence term {self.term} < current {fenced}")
            row["term"] = int(self.term)
        else:
            if int(self.term) != fenced:
                raise OMError(
                    GEO_FENCED,
                    f"checkpoint term {self.term} != fenced {fenced}")
            row["cursor"] = dict(self.cursor)
            if self.bootstrapped is not None:
                row["bootstrapped"] = list(self.bootstrapped)
            if self.stats:
                row["stats"] = dict(self.stats)
        store.put("system", "geo_state", row)
        return dict(row)
