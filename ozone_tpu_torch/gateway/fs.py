"""Hadoop-compatible filesystem adapters (o3fs and rooted ofs).

Port of `ozone_tpu/gateway/fs.py` (the reference's ozonefs adapters):
- OzoneFileSystem (BasicOzoneFileSystem): one bucket as a filesystem.
  On an OBS or LEGACY bucket, path semantics over the flat key namespace
  with directory markers (zero-byte keys ending in "/"), as the
  reference. On an FSO bucket it speaks the OM's directory verbs: mkdirs
  is CreateDirectory, status and listing are GetFileStatus and
  ListStatus, a directory rename moves one row, and a recursive delete
  detaches the subtree for the directory-deleting service. This departs
  from `ozone_tpu` on purpose: its adapter writes an FSO bucket's
  directory markers as zero-byte files, so a nested create there fails
  with NOT_A_DIRECTORY.
- RootedOzoneFileSystem (ofs://): paths are /volume/bucket/rest; the
  first two components address the namespace (volumes and buckets appear
  as directories, mkdirs at depth 1 or 2 creates them), deeper paths go
  to the bucket adapter. Renames cannot cross bucket boundaries. Trash
  (TrashPolicyOzone): deletes move under /<vol>/<bucket>/.Trash/<user>/
  Current, checkpoints rotate and expire.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.storage.ids import StorageError

# a local OzoneManager raises OMError; a remote OM (RemoteOmClient)
# re-raises the same codes as StorageError
_OM_ERRORS = (OMError, StorageError)
_FSO = "FILE_SYSTEM_OPTIMIZED"


def _code(e: Exception) -> str:
    return getattr(e, "code", "")


@dataclass
class FileStatus:
    path: str
    is_dir: bool
    length: int
    modification_time: float
    #: filesystem attributes set via SETOWNER/SETPERMISSION/SETTIMES
    #: (owner, group, permission, mtime, atime); empty when never set
    attrs: dict = None

    def __post_init__(self):
        if self.attrs is None:
            self.attrs = {}
        # explicit SETTIMES overrides the write timestamp
        if "mtime" in self.attrs:
            self.modification_time = self.attrs["mtime"]


class OzoneFile:
    """Read handle with pread/seek (BasicOzoneClientAdapterImpl read
    side). Lazy since round 4: open() costs one metadata lookup, bytes
    arrive through positioned reads in readahead windows — the
    reference's buffered KeyInputStream behavior — so seeking a huge
    file never materializes the skipped ranges. The handle is pinned to
    the key version looked up at open, like the reference's block-list
    snapshot."""

    _READAHEAD = 4 * 1024 * 1024

    def __init__(self, bucket, info: dict):
        self._bucket = bucket
        self._info = info
        self._size = int(info["size"])
        self._pos = 0
        self._buf = b""
        self._buf_off = 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        out = bytearray()
        while n:
            i = self._pos - self._buf_off
            if not 0 <= i < len(self._buf):
                want = min(max(n, self._READAHEAD),
                           self._size - self._pos)
                self._buf = self._bucket.read_key_info_range(
                    self._info, self._pos, want).tobytes()
                self._buf_off = self._pos
                i = 0
            take = min(n, len(self._buf) - i)
            out += self._buf[i : i + take]
            self._pos += take
            n -= take
        return bytes(out)

    def seek(self, pos: int) -> None:
        if not 0 <= pos <= self._size:
            raise ValueError("seek out of range")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


class OzoneFileSystem:
    """One bucket as a filesystem. `layouts` caches (volume, bucket) ->
    whether it keeps a directory tree; a rooted filesystem shares one
    among its bucket adapters."""

    def __init__(self, bucket, layouts: Optional[dict] = None):
        self.bucket = bucket
        self._layouts = {} if layouts is None else layouts

    @property
    def fso(self) -> bool:
        key = (self.bucket.volume, self.bucket.name)
        if key not in self._layouts:
            try:
                info = self.bucket.client.om.bucket_info(*key)
            except _OM_ERRORS:
                return False  # a missing bucket fails as on a flat layout
            self._layouts[key] = info.get("layout") == _FSO
        return self._layouts[key]

    def _fso_status(self, st: dict) -> "FileStatus":
        is_dir = st["type"] == "DIRECTORY"
        return FileStatus(st["name"], is_dir,
                          0 if is_dir else int(st.get("size", 0)),
                          st.get("modified", st.get("created", 0.0)),
                          attrs=st.get("attrs", {}))

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _norm(path: str) -> str:
        p = "/".join(s for s in path.split("/") if s)
        return p

    def _dir_marker(self, path: str) -> str:
        return self._norm(path) + "/"

    # ------------------------------------------------------------- ops
    def create(self, path: str, data, overwrite: bool = True) -> None:
        key = self._norm(path)
        if not overwrite and self.exists(path):
            raise FileExistsError(path)
        # implicit parent dirs: an FSO open materializes the tree itself;
        # the flat layouts use markers
        parts = [] if self.fso else key.split("/")[:-1]
        for i in range(1, len(parts) + 1):
            self.mkdirs("/".join(parts[:i]))
        self.bucket.write_key(key, np.asarray(
            np.frombuffer(data, np.uint8)
            if isinstance(data, (bytes, bytearray)) else data, dtype=np.uint8))

    def open(self, path: str) -> OzoneFile:
        return OzoneFile(self.bucket,
                         self.bucket.lookup_key_info(self._norm(path)))

    def read_range(self, path: str, offset: int = 0,
                   length=None) -> bytes:
        """Positioned read without materializing the whole file (the
        WebHDFS OPEN ?offset/?length fast path): only the covering
        cells/chunks move."""
        # lookup_key_info routes .snapshot/<name>/<key> paths too
        info = self.bucket.lookup_key_info(self._norm(path))
        size = int(info["size"])
        offset = min(max(0, offset), size)
        n = (size - offset if length is None
             else max(0, min(int(length), size - offset)))
        return self.bucket.read_key_info_range(info, offset, n).tobytes()

    def recover_lease(self, path: str) -> bool:
        """Seal an abandoned hsynced write and fence the dead writer
        (BasicOzoneClientAdapterImpl.recoverLease analog)."""
        out = self.bucket.client.om.recover_lease(
            self.bucket.volume, self.bucket.name, self._norm(path)
        )
        return bool(out.get("recovered"))

    def mkdirs(self, path: str) -> None:
        if self.fso:
            if self._norm(path):
                self.bucket.client.om.create_directory(
                    self.bucket.volume, self.bucket.name, self._norm(path))
            return
        marker = self._dir_marker(path)
        try:
            self.bucket.client.om.lookup_key(
                self.bucket.volume, self.bucket.name, marker
            )
        except _OM_ERRORS:
            self.bucket.write_key(marker, np.zeros(0, np.uint8))

    def exists(self, path: str) -> bool:
        try:
            self.get_file_status(path)
            return True
        except FileNotFoundError:
            return False

    def get_file_status(self, path: str) -> FileStatus:
        key = self._norm(path)
        om = self.bucket.client.om
        if key == "":
            return FileStatus("/", True, 0, 0.0)
        if self.fso:
            try:
                return self._fso_status(om.get_file_status(
                    self.bucket.volume, self.bucket.name, key))
            except _OM_ERRORS as e:
                if _code(e) in ("KEY_NOT_FOUND", "BUCKET_NOT_FOUND",
                                "DIRECTORY_NOT_FOUND"):
                    raise FileNotFoundError(path) from None
                raise
        try:
            info = om.lookup_key(self.bucket.volume, self.bucket.name, key)
            return FileStatus(key, False, info["size"],
                              info.get("modified", 0.0),
                              attrs=info.get("attrs", {}))
        except _OM_ERRORS:
            pass
        try:
            info = om.lookup_key(
                self.bucket.volume, self.bucket.name, key + "/"
            )
            return FileStatus(key, True, 0, info.get("modified", 0.0),
                              attrs=info.get("attrs", {}))
        except _OM_ERRORS:
            # implicit directory: any key under the prefix (a missing
            # bucket raises here too and must surface as not-found)
            try:
                children = om.list_keys(
                    self.bucket.volume, self.bucket.name, key + "/"
                )
            except _OM_ERRORS:
                children = []
            if children:
                return FileStatus(key, True, 0, 0.0)
        raise FileNotFoundError(path)

    def list_status(self, path: str) -> list[FileStatus]:
        base = self._norm(path)
        prefix = base + "/" if base else ""
        st = self.get_file_status(path)
        if not st.is_dir:
            return [st]
        om = self.bucket.client.om
        if self.fso:
            return sorted((self._fso_status(e) for e in om.list_status(
                self.bucket.volume, self.bucket.name, base)),
                key=lambda s: s.path)
        keys = om.list_keys(self.bucket.volume, self.bucket.name, prefix)
        out: dict[str, FileStatus] = {}
        for k in keys:
            rest = k["name"][len(prefix):]
            if not rest:
                continue  # the marker itself
            head = rest.split("/")[0]
            child = prefix + head
            if "/" in rest.rstrip("/") or rest.endswith("/"):
                if rest == head + "/":
                    # the immediate child's own marker key: it carries
                    # the directory's attrs (SETPERMISSION/SETOWNER) —
                    # LISTSTATUS must agree with GETFILESTATUS
                    out[child] = FileStatus(
                        child, True, 0, k.get("modified", 0.0),
                        attrs=k.get("attrs", {}))
                else:
                    out.setdefault(child,
                                   FileStatus(child, True, 0, 0.0))
            else:
                out[child] = FileStatus(
                    child, False, k["size"], k.get("modified", 0.0),
                    attrs=k.get("attrs", {}),
                )
        return sorted(out.values(), key=lambda s: s.path)

    def list_status_page(self, path: str, start_after: str = "",
                         limit: int = 1000
                         ) -> tuple[list[FileStatus], bool]:
        """Bounded page of immediate children after child name
        `start_after` (the LISTSTATUS_BATCH backend): key pages come
        from the OM's bounded listing, a directory child's whole
        subtree is skipped via a floor key past it, and server work is
        proportional to the PAGE, not the directory."""
        base = self._norm(path)
        prefix = base + "/" if base else ""
        st = self.get_file_status(path)
        if not st.is_dir:
            return ([st] if not start_after else [], False)
        om = self.bucket.client.om
        if self.fso:
            # one ListStatus of the directory's children, sliced after
            # the named child
            kids = [s for s in self.list_status(path)
                    if not start_after
                    or s.path.rpartition("/")[2] > start_after]
            return kids[:limit], len(kids) > limit
        out: dict[str, FileStatus] = {}
        # resume AFTER the named child: for a dir child the floor must
        # clear its subtree ("name/￿"); for a file child any key
        # > its own name qualifies — the dir floor covers both
        floor = (prefix + start_after + "/￿"
                 if start_after else "")
        while len(out) <= limit:
            keys = om.list_keys(self.bucket.volume, self.bucket.name,
                                prefix, start_after=floor, limit=512)
            if not keys:
                break
            for k in keys:
                rest = k["name"][len(prefix):]
                if not rest:
                    continue
                head = rest.split("/")[0]
                child = prefix + head
                if "/" in rest.rstrip("/") or rest.endswith("/"):
                    if rest == head + "/":
                        out[child] = FileStatus(
                            child, True, 0, k.get("modified", 0.0),
                            attrs=k.get("attrs", {}))
                    else:
                        out.setdefault(
                            child, FileStatus(child, True, 0, 0.0))
                else:
                    out[child] = FileStatus(
                        child, False, k["size"],
                        k.get("modified", 0.0),
                        attrs=k.get("attrs", {}))
                if len(out) > limit:
                    break
            floor = keys[-1]["name"]
        children = sorted(out.values(), key=lambda s: s.path)
        return children[:limit], len(children) > limit

    def delete(self, path: str, recursive: bool = False) -> bool:
        st = self.get_file_status(path)
        om = self.bucket.client.om
        if self.fso:
            key = self._norm(path)
            if not st.is_dir:
                self.bucket.delete_key(key)
                return True
            if not key:
                raise OSError("cannot delete the bucket root")
            try:
                # detached now; the directory-deleting service reaps the
                # subtree
                om.delete_directory(self.bucket.volume, self.bucket.name,
                                    key, recursive=recursive)
            except _OM_ERRORS as e:
                if _code(e) == "DIRECTORY_NOT_EMPTY":
                    raise OSError(f"directory {path} not empty") from None
                raise
            return True
        if st.is_dir:
            children = self.list_status(path)
            if children and not recursive:
                raise OSError(f"directory {path} not empty")
            prefix = self._norm(path) + "/"
            for k in om.list_keys(self.bucket.volume, self.bucket.name, prefix):
                self.bucket.delete_key(k["name"])
            try:
                self.bucket.delete_key(prefix)
            except _OM_ERRORS:
                pass
        else:
            self.bucket.delete_key(self._norm(path))
        return True

    def rename(self, src: str, dst: str) -> None:
        st = self.get_file_status(src)
        s, d = self._norm(src), self._norm(dst)
        om = self.bucket.client.om
        if self.fso:
            # a directory moves as one row; its subtree follows its id
            self.bucket.rename_key(s, d)
            return
        if st.is_dir:
            prefix = s + "/"
            for k in om.list_keys(self.bucket.volume, self.bucket.name, prefix):
                new = d + "/" + k["name"][len(prefix):]
                self.bucket.rename_key(k["name"], new)
        else:
            self.bucket.rename_key(s, d)

    def set_attrs(self, path: str, attrs: dict,
                  preconds: Optional[dict] = None) -> None:
        """SETOWNER/SETPERMISSION/SETTIMES backing (merge semantics;
        None deletes; preconds = atomic xattr flag checks).
        Directories resolve through their marker key."""
        st = self.get_file_status(path)
        key = self._norm(st.path)
        om = self.bucket.client.om
        try:
            om.set_key_attrs(self.bucket.volume, self.bucket.name, key,
                             attrs, preconds)
        except _OM_ERRORS as e:
            # only the missing-marker case retries: a precondition
            # refusal (XATTR_EXISTS/XATTR_NOT_FOUND) must surface, not
            # loop through a second unchecked write
            if self.fso or not st.is_dir or "KEY_NOT_FOUND" not in str(e):
                raise
            # implicit OBS directory: materialize its marker, retry
            self.mkdirs(path)
            om.set_key_attrs(self.bucket.volume, self.bucket.name, key,
                             attrs, preconds)

    def checksum(self, path: str) -> dict:
        """Composite file checksum (the DistributedFileSystem
        getFileChecksum analog; client/file_checksum.py combines
        per-block device CRCs)."""
        from ozone_tpu_torch.client.file_checksum import file_checksum

        st = self.get_file_status(path)
        if st.is_dir:
            raise IsADirectoryError(path)
        return file_checksum(self.bucket.client, self.bucket.volume,
                             self.bucket.name, self._norm(path))

    def append(self, path: str, data) -> None:
        """APPEND: keys are immutable on the datapath, so append is a
        read-modify-write re-put (the reference's OzoneFileSystem throws
        here; the HttpFS surface is served by making the semantic work,
        at O(file) cost for small-file workloads)."""
        buf = np.frombuffer(
            data, np.uint8) if isinstance(data, (bytes, bytearray)) else \
            np.asarray(data, dtype=np.uint8)
        old = self.bucket.read_key(self._norm(path))
        self.bucket.write_key(self._norm(path),
                              np.concatenate([old, buf]))

    def truncate(self, path: str, new_length: int) -> bool:
        """TRUNCATE to `new_length` (must not exceed the current size),
        same read-modify-write tradeoff as append."""
        old = self.bucket.read_key(self._norm(path))
        if new_length > old.size:
            raise OSError(
                f"truncate length {new_length} > size {old.size}")
        self.bucket.write_key(self._norm(path), old[:new_length])
        return True


class RootedOzoneFileSystem:
    """The whole cluster as one filesystem: /volume/bucket/path
    (reference RootedOzoneFileSystem, ofs:// scheme)."""

    def __init__(self, client, replication: Optional[str] = None):
        self.client = client
        # replication for buckets implicitly created by mkdirs
        self.replication = replication
        #: (volume, bucket) -> whether it is an FSO bucket, asked once
        self._layouts: dict[tuple[str, str], bool] = {}

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _split(path: str) -> list[str]:
        return [s for s in path.split("/") if s]

    def _bucket_fs(self, volume: str, bucket: str) -> OzoneFileSystem:
        # function-local: the client's module imports torch, which the
        # adapter's namespace verbs never need
        from ozone_tpu_torch.client.ozone_client import OzoneBucket

        return OzoneFileSystem(OzoneBucket(self.client, volume, bucket),
                               self._layouts)

    def _resolve(self, path: str):
        """-> (volume, bucket, rest) with None for absent components."""
        parts = self._split(path)
        vol = parts[0] if len(parts) >= 1 else None
        bkt = parts[1] if len(parts) >= 2 else None
        rest = "/".join(parts[2:])
        return vol, bkt, rest

    # ------------------------------------------------------------- ops
    def create(self, path: str, data, overwrite: bool = True) -> None:
        vol, bkt, rest = self._resolve(path)
        if not (vol and bkt and rest):
            raise IsADirectoryError(path)
        self._bucket_fs(vol, bkt).create(rest, data, overwrite)

    def open(self, path: str) -> OzoneFile:
        vol, bkt, rest = self._resolve(path)
        if not (vol and bkt and rest):
            raise IsADirectoryError(path)
        return self._bucket_fs(vol, bkt).open(rest)

    def read_range(self, path: str, offset: int = 0,
                   length=None) -> bytes:
        vol, bkt, rest = self._resolve(path)
        if not (vol and bkt and rest):
            raise IsADirectoryError(path)
        return self._bucket_fs(vol, bkt).read_range(rest, offset, length)

    def recover_lease(self, path: str) -> bool:
        vol, bkt, rest = self._resolve(path)
        if not (vol and bkt and rest):
            raise IsADirectoryError(path)
        return self._bucket_fs(vol, bkt).recover_lease(rest)

    def mkdirs(self, path: str) -> None:
        vol, bkt, rest = self._resolve(path)
        om = self.client.om
        if vol:
            try:
                om.volume_info(vol)
            except _OM_ERRORS:
                om.create_volume(vol)
        if vol and bkt:
            try:
                om.bucket_info(vol, bkt)
            except _OM_ERRORS:
                if self.replication:
                    om.create_bucket(vol, bkt, self.replication)
                else:
                    om.create_bucket(vol, bkt)
        if rest:
            self._bucket_fs(vol, bkt).mkdirs(rest)

    def exists(self, path: str) -> bool:
        try:
            self.get_file_status(path)
            return True
        except FileNotFoundError:
            return False

    def get_file_status(self, path: str) -> FileStatus:
        vol, bkt, rest = self._resolve(path)
        om = self.client.om
        try:
            if vol is None:
                return FileStatus("/", True, 0, 0.0)
            if bkt is None:
                v = om.volume_info(vol)
                return FileStatus(vol, True, 0, v.get("created", 0.0))
            if not rest:
                b = om.bucket_info(vol, bkt)
                return FileStatus(f"{vol}/{bkt}", True, 0,
                                  b.get("created", 0.0),
                                  attrs=b.get("attrs", {}))
        except _OM_ERRORS:
            raise FileNotFoundError(path)
        st = self._bucket_fs(vol, bkt).get_file_status(rest)
        return FileStatus(f"{vol}/{bkt}/{st.path}", st.is_dir, st.length,
                          st.modification_time, attrs=st.attrs)

    def list_status(self, path: str) -> list[FileStatus]:
        vol, bkt, rest = self._resolve(path)
        om = self.client.om
        if vol is None:
            return [
                FileStatus(v["name"], True, 0, v.get("created", 0.0))
                for v in om.list_volumes()
            ]
        if bkt is None:
            try:
                om.volume_info(vol)
            except _OM_ERRORS:
                raise FileNotFoundError(path)
            return [
                FileStatus(f"{vol}/{b['name']}", True, 0,
                           b.get("created", 0.0),
                           attrs=b.get("attrs", {}))
                for b in om.list_buckets(vol)
            ]
        out = self._bucket_fs(vol, bkt).list_status(rest)
        return [
            FileStatus(f"{vol}/{bkt}/{s.path}", s.is_dir, s.length,
                       s.modification_time, attrs=s.attrs)
            for s in out
        ]

    def delete(self, path: str, recursive: bool = False) -> bool:
        vol, bkt, rest = self._resolve(path)
        om = self.client.om
        if vol is None:
            raise OSError("cannot delete the root")
        if bkt is None:
            if recursive:
                for b in om.list_buckets(vol):
                    self.delete(f"/{vol}/{b['name']}", recursive=True)
            om.delete_volume(vol)
            return True
        if not rest:
            if recursive:
                fs = self._bucket_fs(vol, bkt)
                for st in fs.list_status(""):
                    fs.delete(st.path, recursive=True)
            om.delete_bucket(vol, bkt)
            self._layouts.pop((vol, bkt), None)
            return True
        return self._bucket_fs(vol, bkt).delete(rest, recursive)

    def rename(self, src: str, dst: str) -> None:
        sv, sb, srest = self._resolve(src)
        dv, db, drest = self._resolve(dst)
        if not (sv and sb and srest and drest):
            raise OSError("rename requires paths inside a bucket")
        if (sv, sb) != (dv, db):
            # same constraint as the reference: no cross-bucket rename
            raise OSError("rename cannot cross bucket boundaries")
        self._bucket_fs(sv, sb).rename(srest, drest)

    def _in_bucket(self, path: str):
        vol, bkt, rest = self._resolve(path)
        if not (vol and bkt and rest):
            raise IsADirectoryError(path)
        return self._bucket_fs(vol, bkt), rest

    # ------------------------------------------------------------- trash
    #: per-bucket trash root (the reference's getTrashRoot:
    #: /<vol>/<bucket>/.Trash/<user>; deletes move under Current, the
    #: emptier rotates Current into timestamped checkpoints and purges
    #: checkpoints older than the interval — TrashPolicyOzone)
    TRASH = ".Trash"

    def trash_delete(self, path: str, user: str = "anonymous",
                     recursive: bool = True) -> str:
        """Move a file/dir into the bucket trash instead of deleting
        (fs -rm without -skipTrash). Returns the trash path."""
        vol, bkt, rest = self._resolve(path)
        if not (vol and bkt and rest):
            raise OSError("only bucket contents can be trashed")
        user = user or "anonymous"  # blank would nest under a
        # pseudo-user the emptier can never parse
        if rest == self.TRASH or rest.startswith(self.TRASH + "/"):
            # already in trash: a second delete is permanent. Exact
            # component match only — a user dir NAMED ".Trash-backup"
            # must still be trashable, not silently destroyed.
            self.delete(path, recursive=True)
            return ""
        fs = self._bucket_fs(vol, bkt)
        st = fs.get_file_status(rest)
        if st.is_dir and not recursive and fs.list_status(rest):
            # the non-recursive safety guard must hold on the trash
            # path too, or skiptrash=false silently bypasses it
            raise OSError(f"directory {path} not empty")
        dst = f"{self.TRASH}/{user}/Current/{rest}"
        # a prior trashed entry at the same path is displaced (the
        # reference appends a numeric suffix; timestamped checkpoints
        # make collisions rare — keep last-in semantics per Current)
        if fs.exists(dst):
            fs.delete(dst, recursive=True)
        fs.mkdirs("/".join(dst.split("/")[:-1]))
        fs.rename(rest, dst)
        return f"/{vol}/{bkt}/{dst}"

    def trash_checkpoint(self,
                         user: Optional[str] = None) -> list[str]:
        """Rotate Current into a timestamped checkpoint
        (Trash.checkpoint) for `user`, or for EVERY user with trash
        when None (the emptier covers all principals); returns the
        checkpoint paths created."""
        out = []
        stamp = time.strftime("%y%m%d%H%M%S")
        for v in self.client.om.list_volumes():
            for b in self.client.om.list_buckets(v["name"]):
                fs = self._bucket_fs(v["name"], b["name"])
                if user is not None:
                    users = [user]
                else:
                    try:
                        users = [u.path.rpartition("/")[2]
                                 for u in fs.list_status(self.TRASH)]
                    except FileNotFoundError:
                        continue
                for u in users:
                    cur = f"{self.TRASH}/{u}/Current"
                    if not fs.exists(cur):
                        continue
                    dst = f"{self.TRASH}/{u}/{stamp}"
                    n = 0
                    while fs.exists(dst):  # two rotations in a second
                        n += 1
                        dst = f"{self.TRASH}/{u}/{stamp}-{n}"
                    fs.rename(cur, dst)
                    out.append(f"/{v['name']}/{b['name']}/{dst}")
        return out

    def trash_expunge(self, older_than_s: float,
                      now: Optional[float] = None) -> list[str]:
        """Purge trash checkpoints older than the interval (the
        TrashPolicyOzone emptier). Checkpoint age comes from its
        timestamp name; Current is never purged here."""
        purged = []
        now = now if now is not None else time.time()
        for v in self.client.om.list_volumes():
            for b in self.client.om.list_buckets(v["name"]):
                fs = self._bucket_fs(v["name"], b["name"])
                troot = self.TRASH
                try:
                    users = fs.list_status(troot)
                except FileNotFoundError:
                    continue
                for u in users:
                    for cp in fs.list_status(u.path):
                        name = cp.path.rpartition("/")[2]
                        if name == "Current":
                            continue
                        try:
                            ts = time.mktime(time.strptime(
                                name.partition("-")[0], "%y%m%d%H%M%S"))
                        except ValueError:
                            continue
                        if now - ts >= older_than_s:
                            fs.delete(cp.path, recursive=True)
                            purged.append(
                                f"/{v['name']}/{b['name']}/{cp.path}")
        return purged

    def list_status_page(self, path: str, start_after: str = "",
                         limit: int = 1000
                         ) -> tuple[list[FileStatus], bool]:
        vol, bkt, rest = self._resolve(path)
        if vol and bkt:
            page, more = self._bucket_fs(vol, bkt).list_status_page(
                rest, start_after=start_after, limit=limit)
            return ([FileStatus(f"{vol}/{bkt}/{s.path}", s.is_dir,
                                s.length, s.modification_time,
                                attrs=s.attrs) for s in page], more)
        # volume / root levels are small namespaces: slice the full list
        sts = [s for s in self.list_status(path)
               if not start_after
               or s.path.rstrip("/").rpartition("/")[2] > start_after]
        return sts[:limit], len(sts) > limit

    def set_attrs(self, path: str, attrs: dict,
                  preconds: Optional[dict] = None) -> None:
        vol, bkt, rest = self._resolve(path)
        if vol and bkt and not rest:
            # buckets appear as directories at depth 2 — chmod/chown on
            # a mount's top level lands on the bucket row itself
            self.client.om.set_bucket_attrs(vol, bkt, attrs)
            return
        fs, rest = self._in_bucket(path)
        fs.set_attrs(rest, attrs, preconds)

    def checksum(self, path: str) -> dict:
        fs, rest = self._in_bucket(path)
        return fs.checksum(rest)

    def append(self, path: str, data) -> None:
        fs, rest = self._in_bucket(path)
        fs.append(rest, data)

    def truncate(self, path: str, new_length: int) -> bool:
        fs, rest = self._in_bucket(path)
        return fs.truncate(rest, new_length)
