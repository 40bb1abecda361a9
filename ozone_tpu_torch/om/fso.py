"""FILE_SYSTEM_OPTIMIZED (FSO) bucket layout: a true directory tree.

Port of `ozone_tpu/om/fso.py` (the reference's FSO layout: key requests
routed to the OMFileCreateRequest / OMDirectoryCreateRequest /
OMKeyRenameRequestWithFSO variants over a directoryTable and fileTable
keyed by parent object id). Entries are stored as

    dirs :  /{volume}/{bucket}/{parentId}/{name} -> {object_id, ...}
    files:  /{volume}/{bucket}/{parentId}/{name} -> key info

so a directory rename is O(1) — only the directory's own entry moves;
children key off its immutable object id. Recursive delete moves the dir
entry to the deleted_dirs table and a background DirectoryDeletingService
(reference: service/DirectoryDeletingService.java) walks the subtree,
feeding files into the deleted-key purge chain.

Object ids are allocated in pre_execute on the leader and carried inside
the request, so a follower's apply on the metadata ring is deterministic
(the OMClientRequest preExecute/validateAndUpdateCache contract). The
requests, error codes and rows are the reference's, field for field.
An open carries the explicit ACLs a caller fixed for the file (as
`requests.OpenKey` does). Left out, as the port's OBS commit and
`om/multipart.py` leave them out: the snapshots' copy-on-write pre-images
of FSO rows (no snapshots in the port yet), and the envelope-encryption
bundle an open may carry (KMS is a later slice).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from ozone_tpu_torch.om.metadata import OMMetadataStore, bucket_key
from ozone_tpu_torch.om.requests import (
    BUCKET_NOT_FOUND,
    KEY_NOT_FOUND,
    OMError,
    OMRequest,
    check_and_charge_quota,
    check_attr_preconds,
    check_rewrite_fence,
    erase_gdpr_secret,
    finalize_commit,
)

DIRECTORY_NOT_FOUND = "DIRECTORY_NOT_FOUND"
DIRECTORY_NOT_EMPTY = "DIRECTORY_NOT_EMPTY"
NOT_A_FILE = "NOT_A_FILE"
NOT_A_DIRECTORY = "NOT_A_DIRECTORY"
FILE_ALREADY_EXISTS = "FILE_ALREADY_EXISTS"

ROOT_ID = "0"  # every bucket's root directory object id


def split_path(path: str) -> list[str]:
    parts = [p for p in path.strip("/").split("/") if p]
    for p in parts:
        if p in (".", ".."):
            raise OMError(NOT_A_FILE, f"illegal path component {p!r}")
    return parts


def dir_key(volume: str, bucket: str, parent_id: str, name: str) -> str:
    return f"/{volume}/{bucket}/{parent_id}/{name}"


def id_key(volume: str, bucket: str, object_id: str) -> str:
    return f"/{volume}/{bucket}/{object_id}"


def dir_alive(
    store: OMMetadataStore, volume: str, bucket: str, object_id: str
) -> bool:
    return object_id == ROOT_ID or store.exists(
        "dir_ids", id_key(volume, bucket, object_id)
    )


def resolve(
    store: OMMetadataStore, volume: str, bucket: str, path: str
) -> tuple[str, list[str]]:
    """Walk the directory tree; return (deepest existing dir's object id,
    unresolved trailing components)."""
    parts = split_path(path)
    parent = ROOT_ID
    for i, name in enumerate(parts):
        d = store.get("dirs", dir_key(volume, bucket, parent, name))
        if d is None:
            return parent, parts[i:]
        parent = d["object_id"]
    return parent, []


def resolve_parent(
    store: OMMetadataStore, volume: str, bucket: str, path: str
) -> tuple[str, str]:
    """Resolve the parent directory of `path`; return (parent_id, name).
    Raises DIRECTORY_NOT_FOUND if an intermediate component is missing."""
    parts = split_path(path)
    if not parts:
        raise OMError(NOT_A_FILE, "empty path")
    parent, missing = resolve(store, volume, bucket, "/".join(parts[:-1]))
    if missing:
        raise OMError(DIRECTORY_NOT_FOUND, "/".join(parts[:-1]))
    return parent, parts[-1]


def _require_bucket(store: OMMetadataStore, volume: str, bucket: str) -> dict:
    b = store.get("buckets", bucket_key(volume, bucket))
    if b is None:
        raise OMError(BUCKET_NOT_FOUND, f"{volume}/{bucket}")
    return b


def _ensure_parents(
    store: OMMetadataStore,
    volume: str,
    bucket: str,
    parts: list[str],
    new_ids: list[str],
    created: float,
    conflict_code: str,
) -> str:
    """Create any missing directory components along `parts`, using the
    leader-assigned `new_ids` for determinism; return the final dir's
    object id. A file occupying a component raises `conflict_code`."""
    parent = ROOT_ID
    for i, name in enumerate(parts):
        dk = dir_key(volume, bucket, parent, name)
        d = store.get("dirs", dk)
        if d is None:
            if store.exists("files", dk):
                raise OMError(conflict_code, dk)
            d = {
                "object_id": new_ids[i],
                "name": name,
                "parent_id": parent,
                "created": created,
            }
            idk = id_key(volume, bucket, d["object_id"])
            store.put("dirs", dk, d)
            store.put("dir_ids", idk,
                      {"parent_id": parent, "name": name})
        parent = d["object_id"]
    return parent


@dataclass
class CreateDirectory(OMRequest):
    """mkdir -p: creates all missing components (OMDirectoryCreateRequest
    with MissingParentInfos, reference request/file/)."""

    volume: str
    bucket: str
    path: str
    # ids pre-allocated on the leader, one per possibly-missing component
    new_ids: list[str] = field(default_factory=list)
    created: float = 0.0

    def pre_execute(self, om) -> None:
        self.created = time.time()
        self.new_ids = [
            uuid.uuid4().hex[:16] for _ in split_path(self.path)
        ]

    def apply(self, store):
        _require_bucket(store, self.volume, self.bucket)
        return _ensure_parents(
            store, self.volume, self.bucket, split_path(self.path),
            self.new_ids, self.created, FILE_ALREADY_EXISTS,
        )


@dataclass
class OpenFile(OMRequest):
    """Open a file for write, creating missing parent dirs
    (OMFileCreateRequest semantics)."""

    volume: str
    bucket: str
    path: str
    client_id: str
    replication: str
    checksum_type: str = "CRC32C"
    bytes_per_checksum: int = 16 * 1024
    overwrite: bool = True
    new_dir_ids: list[str] = field(default_factory=list)
    created: float = 0.0
    metadata: dict = field(default_factory=dict)
    #: stable identity of this file version (OmKeyInfo objectID) —
    #: rename-carried, overwrite-fresh; snapdiff pairs rows by it
    file_id: str = ""
    #: explicit ACLs fixed at open (see requests.OpenKey.acls)
    acls: list = field(default_factory=list)

    def pre_execute(self, om) -> None:
        self.created = time.time()
        self.new_dir_ids = [
            uuid.uuid4().hex[:16] for _ in split_path(self.path)
        ]
        self.file_id = uuid.uuid4().hex[:16]

    def apply(self, store):
        _require_bucket(store, self.volume, self.bucket)
        parts = split_path(self.path)
        if not parts:
            raise OMError(NOT_A_FILE, "empty path")
        parent = _ensure_parents(
            store, self.volume, self.bucket, parts[:-1],
            self.new_dir_ids, self.created, NOT_A_DIRECTORY,
        )
        name = parts[-1]
        fk = dir_key(self.volume, self.bucket, parent, name)
        if store.exists("dirs", fk):
            raise OMError(NOT_A_FILE, f"{fk} is a directory")
        if not self.overwrite and store.exists("files", fk):
            raise OMError(FILE_ALREADY_EXISTS, fk)
        row = {
            "volume": self.volume,
            "bucket": self.bucket,
            "name": self.path.strip("/"),
            "object_id": self.file_id,
            "file_name": name,
            "parent_id": parent,
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
        store.put("open_keys", f"{fk}/{self.client_id}", row)
        return parent


@dataclass
class CommitFile(OMRequest):
    """Move an open-file session into the file table (OMFileCreateRequest's
    commit counterpart, keyed by parent object id)."""

    volume: str
    bucket: str
    parent_id: str
    file_name: str
    client_id: str
    size: int
    block_groups: list[dict] = field(default_factory=list)
    modified: float = 0.0
    hsync: bool = False
    #: rewrite fence — see CommitKey.expect_object_id
    expect_object_id: str = ""
    expect_generation: int = -1

    def pre_execute(self, om) -> None:
        self.modified = time.time()

    def apply(self, store):
        fk = dir_key(self.volume, self.bucket, self.parent_id, self.file_name)
        open_k = f"{fk}/{self.client_id}"
        info = store.get("open_keys", open_k)
        if info is None:
            raise OMError(KEY_NOT_FOUND, f"no open session {open_k}")
        if not dir_alive(store, self.volume, self.bucket, self.parent_id):
            # parent was recursively deleted while the key was open; refuse
            # the commit so the file row can't become unreachable, and hand
            # the already-written blocks to the deleted-key purge chain
            store.delete("open_keys", open_k)
            info.update(size=self.size, block_groups=self.block_groups)
            erase_gdpr_secret(info)
            store.put("deleted_keys", f"{fk}:{self.modified}", info)
            raise OMError(DIRECTORY_NOT_FOUND,
                          f"parent of {fk} deleted during write")
        info.update(
            {
                "size": self.size,
                "block_groups": self.block_groups,
                "modified": self.modified,
            }
        )
        old = store.get("files", fk)
        check_rewrite_fence(store, self.expect_object_id, old, open_k,
                            fk, info, self.modified,
                            self.expect_generation)
        finalize_commit(store, "files", fk, info, old, self.client_id,
                        self.hsync, self.modified)
        return info


@dataclass
class DeleteFile(OMRequest):
    volume: str
    bucket: str
    path: str
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        parent, name = resolve_parent(store, self.volume, self.bucket, self.path)
        fk = dir_key(self.volume, self.bucket, parent, name)
        info = store.get("files", fk)
        if info is None:
            if store.exists("dirs", fk):
                raise OMError(NOT_A_FILE, f"{fk} is a directory")
            raise OMError(KEY_NOT_FOUND, fk)
        store.delete("files", fk)
        # fence a live hsync stream before purging its blocks
        stale_writer = info.get("hsync_client_id")
        if stale_writer:
            store.delete("open_keys", f"{fk}/{stale_writer}")
        erase_gdpr_secret(info)
        store.put("deleted_keys", f"{fk}:{self.ts}", info)
        check_and_charge_quota(store, self.volume, self.bucket,
                               -int(info.get("size", 0)), -1)
        return info


@dataclass
class DeleteDirectory(OMRequest):
    """Detach a directory (recursive) or remove an empty one. The subtree
    is purged asynchronously by DirectoryDeletingService — matching the
    reference where OMKeyDeleteRequestWithFSO moves the dir into the
    deletedDirectoryTable."""

    volume: str
    bucket: str
    path: str
    recursive: bool = False
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        parent, name = resolve_parent(store, self.volume, self.bucket, self.path)
        dk = dir_key(self.volume, self.bucket, parent, name)
        d = store.get("dirs", dk)
        if d is None:
            raise OMError(DIRECTORY_NOT_FOUND, dk)
        prefix = f"/{self.volume}/{self.bucket}/{d['object_id']}/"
        has_children = (
            next(store.iterate("dirs", prefix), None) is not None
            or next(store.iterate("files", prefix), None) is not None
        )
        if has_children and not self.recursive:
            raise OMError(DIRECTORY_NOT_EMPTY, dk)
        idk = id_key(self.volume, self.bucket, d["object_id"])
        store.delete("dirs", dk)
        store.delete("dir_ids", idk)
        store.put(
            "deleted_dirs",
            f"/{self.volume}/{self.bucket}/{d['object_id']}:{self.ts}",
            {"volume": self.volume, "bucket": self.bucket, **d},
        )


@dataclass
class SetEntryAttrs(OMRequest):
    """Merge filesystem attributes (owner/group/permission/mtime/atime)
    into a file or directory row (the FSO side of HttpFS SETOWNER /
    SETPERMISSION / SETTIMES). A None value deletes the attribute;
    `preconds` enforces the xattr CREATE/REPLACE flags atomically."""

    volume: str
    bucket: str
    path: str
    attrs: dict
    preconds: dict = field(default_factory=dict)

    def apply(self, store):
        parent, name = resolve_parent(
            store, self.volume, self.bucket, self.path
        )
        ek = dir_key(self.volume, self.bucket, parent, name)
        table = "dirs" if store.exists("dirs", ek) else "files"
        info = store.get(table, ek)
        if info is None:
            raise OMError(KEY_NOT_FOUND, ek)
        check_attr_preconds(info, self.preconds)
        merged = dict(info.get("attrs", {}))
        for k, v in self.attrs.items():
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        info["attrs"] = merged
        store.put(table, ek, info)
        return info


@dataclass
class RenameEntry(OMRequest):
    """Rename a file or directory. Directory rename moves ONE row — the
    whole subtree follows because children are keyed by the directory's
    object id (OMKeyRenameRequestWithFSO)."""

    volume: str
    bucket: str
    src: str
    dst: str
    ts: float = 0.0

    def pre_execute(self, om) -> None:
        self.ts = time.time()

    def apply(self, store):
        src_parent, src_name = resolve_parent(
            store, self.volume, self.bucket, self.src
        )
        dst_parent, dst_name = resolve_parent(
            store, self.volume, self.bucket, self.dst
        )
        sk = dir_key(self.volume, self.bucket, src_parent, src_name)
        dk = dir_key(self.volume, self.bucket, dst_parent, dst_name)
        if store.exists("dirs", dk) or store.exists("files", dk):
            raise OMError(FILE_ALREADY_EXISTS, dk)
        d = store.get("dirs", sk)
        if d is not None:
            # moving a dir under its own subtree would orphan it
            p = dst_parent
            while p != ROOT_ID:
                if p == d["object_id"]:
                    raise OMError(NOT_A_DIRECTORY,
                                  f"cannot move {sk} into its own subtree")
                p = _parent_of(store, self.volume, self.bucket, p)
            idk = id_key(self.volume, self.bucket, d["object_id"])
            d.update(name=dst_name, parent_id=dst_parent, modified=self.ts)
            store.delete("dirs", sk)
            store.put("dirs", dk, d)
            store.put("dir_ids", idk,
                      {"parent_id": dst_parent, "name": dst_name})
            return d
        f = store.get("files", sk)
        if f is None:
            raise OMError(KEY_NOT_FOUND, sk)
        f.update(file_name=dst_name, parent_id=dst_parent, modified=self.ts)
        store.delete("files", sk)
        store.put("files", dk, f)
        return f


def _parent_of(
    store: OMMetadataStore, volume: str, bucket: str, object_id: str
) -> str:
    """O(1) parent lookup via the dir_ids index (rename-cycle check)."""
    e = store.get("dir_ids", id_key(volume, bucket, object_id))
    return e["parent_id"] if e else ROOT_ID


@dataclass
class PurgeDirectories(OMRequest):
    """Apply one batch of DirectoryDeletingService work: move files under
    deleted dirs into deleted_keys, re-queue child dirs, drop finished
    entries (reference service/DirectoryDeletingService.java purge path)."""

    # [(deleted_dirs key to drop, [(file key, info)...], [(child dir key, info)...])]
    drops: list[str] = field(default_factory=list)
    file_moves: list[list] = field(default_factory=list)  # [files key, info, ts]
    dir_moves: list[list] = field(default_factory=list)  # [deleted_dirs key, info]

    def apply(self, store):
        for fk, info, ts in self.file_moves:
            store.delete("files", fk)
            erase_gdpr_secret(info)
            store.put("deleted_keys", f"{fk}:{ts}", info)
            _, vol, bkt = fk.split("/", 3)[:3]
            check_and_charge_quota(store, vol, bkt,
                                   -int(info.get("size", 0)), -1)
        for dk, info in self.dir_moves:
            idk = id_key(info["volume"], info["bucket"],
                         info["object_id"])
            store.delete("dirs", dk)
            store.delete("dir_ids", idk)
            store.put("deleted_dirs", dk_suffix(dk, info), info)
        for k in self.drops:
            # re-check emptiness at apply time: a file committed between the
            # service's scan and this apply must not be orphaned
            info = store.get("deleted_dirs", k)
            if info is not None:
                prefix = (f"/{info['volume']}/{info['bucket']}/"
                          f"{info['object_id']}/")
                if (next(store.iterate("files", prefix), None) is not None
                        or next(store.iterate("dirs", prefix), None)
                        is not None):
                    continue  # keep queued; next pass collects the stragglers
            store.delete("deleted_dirs", k)


def dk_suffix(dk: str, info: dict) -> str:
    return f"/{info['volume']}/{info['bucket']}/{info['object_id']}:{info.get('ts', 0)}"


class DirectoryDeletingService:
    """Background subtree reaper. Each run() pass collects up to `limit`
    children of detached directories and submits one PurgeDirectories
    request (so HA replicas stay in sync)."""

    def __init__(self, om):
        self.om = om

    def run_once(self, limit: int = 256) -> int:
        store = self.om.store
        drops: list[str] = []
        file_moves: list[list] = []
        dir_moves: list[list] = []
        n = 0
        ts = time.time()
        for ddk, d in list(store.iterate("deleted_dirs")):
            if n >= limit:
                break
            vol, bkt = d["volume"], d["bucket"]
            prefix = f"/{vol}/{bkt}/{d['object_id']}/"
            exhausted = True
            for fk, info in store.iterate("files", prefix):
                file_moves.append([fk, info, ts])
                n += 1
                if n >= limit:
                    exhausted = False
                    break
            if exhausted:
                for dk, child in store.iterate("dirs", prefix):
                    dir_moves.append(
                        [dk, {"volume": vol, "bucket": bkt, "ts": ts, **child}]
                    )
                    n += 1
                    if n >= limit:
                        exhausted = False
                        break
            if exhausted:
                drops.append(ddk)
                n += 1
        if not (drops or file_moves or dir_moves):
            return 0
        self.om.submit(
            PurgeDirectories(
                drops=drops, file_moves=file_moves, dir_moves=dir_moves
            )
        )
        return n

    def run_to_completion(self, max_rounds: int = 1000) -> int:
        total = 0
        for _ in range(max_rounds):
            got = self.run_once()
            if got == 0:
                return total
            total += got
        return total


# --------------------------------------------------------------- read paths
def get_status(
    store: OMMetadataStore, volume: str, bucket: str, path: str
) -> dict:
    """getFileStatus: file or directory info (reference
    KeyManagerImpl.getFileStatus)."""
    parts = split_path(path)
    if not parts:
        return {"type": "DIRECTORY", "name": "", "object_id": ROOT_ID}
    parent, missing = resolve(store, volume, bucket, "/".join(parts[:-1]))
    if missing:
        raise OMError(KEY_NOT_FOUND, path)
    ek = dir_key(volume, bucket, parent, parts[-1])
    d = store.get("dirs", ek)
    if d is not None:
        return {"type": "DIRECTORY", **d, "name": "/".join(parts)}
    f = store.get("files", ek)
    if f is not None:
        # 'name' is derived from the traversal, never from the stored row —
        # ancestors may have been renamed since the file was written
        return {"type": "FILE", **f, "name": "/".join(parts)}
    raise OMError(KEY_NOT_FOUND, path)


def _list_children(
    store: OMMetadataStore, volume: str, bucket: str, object_id: str,
    base: str,
) -> list[dict]:
    """Immediate children of a directory known by object id — no path
    re-resolution. Dirs first then files, each sorted by name."""
    prefix = f"/{volume}/{bucket}/{object_id}/"
    out = []
    for _, d in store.iterate("dirs", prefix):
        full = f"{base}/{d['name']}" if base else d["name"]
        out.append({"type": "DIRECTORY", **d, "path": full, "name": full})
    for _, f in store.iterate("files", prefix):
        full = f"{base}/{f['file_name']}" if base else f["file_name"]
        out.append({"type": "FILE", **f, "path": full, "name": full})
    return out


def list_status(
    store: OMMetadataStore, volume: str, bucket: str, path: str
) -> list[dict]:
    """listStatus: immediate children of a directory (or the file itself)."""
    st = get_status(store, volume, bucket, path)
    if st["type"] != "DIRECTORY":
        return [st]
    return _list_children(store, volume, bucket, st["object_id"],
                          "/".join(split_path(path)))


def walk_files_paged(
    store: OMMetadataStore, volume: str, bucket: str,
    prefix: str = "", start_after: str = "",
    limit: Optional[int] = None,
) -> list[dict]:
    """Lexicographic path-order file walk with subtree pruning: a
    directory is descended only if its path range can still contain
    entries matching `prefix` and beyond `start_after`; the walk stops
    once `limit` files are collected. This is the paged listKeys backend
    for FSO buckets — a page costs O(page + touched-directory scans),
    not a full-tree walk."""
    out: list[dict] = []
    if limit is not None and limit <= 0:
        return out

    def _children_window(object_id: str, base: str, floor: str,
                         include_floor_dir: bool):
        """One bounded sibling window of a directory, name-ordered with
        dirs expanding at their path position. `floor` is the sibling
        name to resume from (exclusive for files; the dir of that name
        is included when the cursor descends into it)."""
        kprefix = f"/{volume}/{bucket}/{object_id}/"
        want = None if limit is None else (limit - len(out) + 1)
        ents = []
        if include_floor_dir and floor:
            bd = store.get("dirs", dir_key(volume, bucket, object_id,
                                           floor))
            if bd is not None:
                full = f"{base}/{floor}" if base else floor
                ents.append({"type": "DIRECTORY", **bd, "path": full,
                             "name": full})
        sa = (kprefix + floor) if floor else ""
        drained = True
        for table, kind in (("dirs", "DIRECTORY"), ("files", "FILE")):
            rows = store.iterate_range(table, kprefix, start_after=sa,
                                       limit=want)
            if want is not None and len(rows) >= want:
                drained = False
            for _, e in rows:
                nm = e["name"] if kind == "DIRECTORY" else e["file_name"]
                full = f"{base}/{nm}" if base else nm
                ents.append({"type": kind, **e, "path": full,
                             "name": full})
        ents.sort(key=lambda e: e["name"] +
                  ("/" if e["type"] == "DIRECTORY" else ""))
        return ents, drained

    def _walk(object_id: str, base: str) -> bool:
        """Returns True when the limit is reached (stop unwinding)."""
        # resume floor: the next path segment of the cursor inside this
        # directory (pushed into the store scan so a page never re-reads
        # already-served siblings)
        floor = ""
        if start_after:
            if not base:
                floor = start_after.split("/", 1)[0]
            elif start_after.startswith(base + "/"):
                floor = start_after[len(base) + 1:].split("/", 1)[0]
        include_floor_dir = True
        while True:
            ents, drained = _children_window(object_id, base, floor,
                                             include_floor_dir)
            include_floor_dir = False
            for e in ents:
                floor = max(floor, e["name"].rsplit("/", 1)[-1])
                if e["type"] == "FILE":
                    name = e["name"]
                    if prefix and not name.startswith(prefix):
                        continue
                    if start_after and name <= start_after:
                        continue
                    out.append(e)
                    if limit is not None and len(out) >= limit:
                        return True
                else:
                    p = e["name"] + "/"
                    # prune: subtree cannot match the prefix
                    if prefix and not (p.startswith(prefix)
                                       or prefix.startswith(p)):
                        continue
                    # prune: every descendant sorts before the cursor
                    if (start_after and start_after > p
                            and not start_after.startswith(p)):
                        continue
                    if _walk(e["object_id"], e["path"]):
                        return True
            if drained or not ents:
                return False

    _walk(ROOT_ID, "")
    return out


def lookup_file(
    store: OMMetadataStore, volume: str, bucket: str, path: str
) -> dict:
    st = get_status(store, volume, bucket, path)
    if st["type"] != "FILE":
        raise OMError(NOT_A_FILE, path)
    return st
