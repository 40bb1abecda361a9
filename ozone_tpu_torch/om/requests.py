"""OM write requests: the preExecute / apply split.

Port of the namespace and key requests of `ozone_tpu/om/requests.py` (the
reference's OMClientRequest pattern: `pre_execute(om)` normalizes and
assigns ids and timestamps on the leader, `apply(store)` is the
deterministic mutation every replica would run). Rows are the
reference's JSON, field for field. Kept: volume and bucket create and
delete, key open, commit (with the quota charge, the overwrite's move to
the purge chain and the rewrite fence), delete and purge, for OBJECT_STORE
and LEGACY buckets. Left out for later slices: FSO, snapshots (and so
their copy-on-write pre-images), multipart, small objects, hsync leases,
ACL and tenant verbs, S3 secrets, delegation tokens, lifecycle and geo
replication, quotas' set and repair verbs.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from ozone_tpu_torch.om.metadata import (
    OMMetadataStore,
    bucket_key,
    key_key,
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
QUOTA_EXCEEDED = "QUOTA_EXCEEDED"
FILE_ALREADY_EXISTS = "FILE_ALREADY_EXISTS"
NOT_A_DIRECTORY = "NOT_A_DIRECTORY"
INVALID_REQUEST = "INVALID_REQUEST"


@dataclass
class OMRequest:
    def pre_execute(self, om: Any) -> None:  # noqa: D401
        """Leader-side phase; default no-op."""

    def apply(self, store: OMMetadataStore) -> Any:
        raise NotImplementedError


def inherit_defaults(parent_acls: list[dict]) -> list[dict]:
    """DEFAULT grants on the parent become ACCESS grants on a new child
    (the reference's OzoneAclUtil.inheritDefaultAcls, on the stored JSON
    form of a grant)."""
    return [
        {"type": d["type"], "name": d.get("name", ""),
         "rights": sorted(d["rights"]), "scope": "ACCESS"}
        for d in parent_acls if d.get("scope", "ACCESS") == "DEFAULT"
    ]


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

    #: the layouts this port serves: OBS (flat object table) and LEGACY
    #: (flat table with filesystem path semantics); FSO is not ported
    LAYOUTS = ("OBJECT_STORE", "LEGACY")

    def pre_execute(self, om) -> None:
        self.created = time.time()

    def apply(self, store):
        if self.layout not in self.LAYOUTS:
            raise OMError(INVALID_REQUEST,
                          f"unknown bucket layout {self.layout!r}")
        vrow = store.get("volumes", volume_key(self.volume))
        if vrow is None:
            raise OMError(VOLUME_NOT_FOUND, self.volume)
        k = bucket_key(self.volume, self.bucket)
        if store.exists("buckets", k):
            raise OMError(BUCKET_ALREADY_EXISTS, k)
        store.put("buckets", k, {
            "volume": self.volume,
            "name": self.bucket,
            "replication": self.replication,
            "layout": self.layout,
            "versioning": self.versioning,
            "created": self.created,
            "acls": inherit_defaults(vrow.get("acls", [])),
        })


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


def finalize_commit(store, table: str, ek: str, info: dict, old,
                    client_id: str, modified: float) -> None:
    """The commit tail: charge quota (the new size minus what the previous
    version charged), bump the row's generation, drop the open session,
    and route a superseded previous version to the purge chain, fencing
    its writer first if it was a live hsync stream (a row the reference
    wrote)."""
    _, vol, bkt = ek.split("/", 3)[:3]
    check_and_charge_quota(
        store, vol, bkt,
        int(info.get("size", 0)) - (int(old.get("size", 0)) if old else 0),
        0 if old is not None else 1,
    )
    # per-commit generation (OmKeyInfo updateID): the rewrite fence
    # detects any commit in between by it
    info["generation"] = (int(old.get("generation", 0)) + 1
                          if old is not None else 1)
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
    """Finalize a key: move the open-key session into the key table."""

    volume: str
    bucket: str
    key: str
    client_id: str
    size: int
    block_groups: list[dict] = field(default_factory=list)
    replication: str = ""
    modified: float = 0.0
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
                        self.modified)
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
    fs_paths: bool = False
    #: stable identity of this key version (OmKeyInfo objectID)
    key_id: str = ""

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
        if self.fs_paths:
            row["fs_paths"] = True  # the commit materializes parent markers
        store.put("open_keys", f"{kk}/{self.client_id}", row)


@dataclass
class DeleteKey(OMRequest):
    """Move a key to the deleted table for the purge chain."""

    volume: str
    bucket: str
    key: str
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        kk = key_key(self.volume, self.bucket, self.key)
        info = store.get("keys", kk)
        if info is None:
            raise OMError(KEY_NOT_FOUND, kk)
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
class PurgeDeletedKeys(OMRequest):
    """Remove processed entries from the deleted table (the key-deleting
    service's completion)."""

    entries: list[str] = field(default_factory=list)

    def apply(self, store):
        for k in self.entries:
            store.delete("deleted_keys", k)
