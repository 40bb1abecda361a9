"""OM bucket snapshots and the snapshot diff.

Port of `ozone_tpu/om/snapshots.py` (the reference's OmSnapshotManager and
SnapshotDiffManager over this store). Every new snapshot is copy-on-write:
creating one writes only its chain row, and its overlay (rows under
`/.snapshot/<volume>/<bucket>/<snap_id>/` in `keys`) fills with the
pre-images the mutating applies keep (`requests.preserve_preimage`,
`requests.preserve_fso_preimage`). The value at a snapshot is the oldest
overlay entry among the snapshots from it to the newest, else the live
row; ABSENT markers keep later keys out. Materialized snapshots (written
before copy-on-write, by the reference) hold all their rows and read as
they are. FSO snapshots read the directory tree as of the snapshot
through `SnapshotStoreView`, so `om/fso.py`'s read machinery runs
unchanged against it.

The diff compares two snapshots, or a snapshot and the live bucket, by
key: added, deleted, modified, and renamed (a delete and an add with one
object id). It is served from the update journal between the two
snapshots' markers (O(changes)), else from the union of the overlays
between them, else by comparing the full listings. `SnapshotDiffJobs`
runs diffs as jobs whose reports are paged.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from ozone_tpu_torch.om import fso
from ozone_tpu_torch.om.requests import (
    INVALID_REQUEST,
    KEY_NOT_FOUND,
    SNAPSHOT_NOT_FOUND,
    CreateSnapshot,
    DeleteSnapshot,
    OMError,
    bucket_snapshots,
    is_absent_marker,
    snap_prefix,
    snapmeta_key,
)


@dataclass
class SnapshotInfo:
    volume: str
    bucket: str
    name: str
    snap_id: str
    created: float
    previous: Optional[str] = None  # the chain's link
    #: copy-on-write (the overlay holds only pre-images of rows mutated
    #: while it was newest); False = materialized at create
    cow: bool = False
    #: copy-on-write over the FSO tables: reads walk the tree as of the
    #: snapshot through SnapshotStoreView
    fso: bool = False

    def to_json(self) -> dict:
        return self.__dict__.copy()


class SnapshotStoreView:
    """Read-only store serving the FSO tables (dirs, files, dir_ids) as
    of a copy-on-write snapshot: a get resolves to the oldest overlay
    entry among `snaps` (this snapshot to the newest, oldest first), else
    the live row. Other tables pass through to the live store."""

    _COW_TABLES = ("dirs", "files", "dir_ids")

    def __init__(self, store, volume: str, bucket: str,
                 snaps: list[dict]):
        self._store = store
        self._volume = volume
        self._bucket = bucket
        self._snaps = snaps

    def _okey(self, snap_id: str, table: str, key: str) -> str:
        return (f"{snap_prefix(self._volume, self._bucket, snap_id)}"
                f"/#{table}#{key}")

    def get(self, table: str, key: str):
        if table not in self._COW_TABLES:
            return self._store.get(table, key)
        for s in self._snaps:
            v = self._store.get("keys", self._okey(s["snap_id"], table, key))
            if v is not None:
                return None if is_absent_marker(v) else v
        return self._store.get(table, key)

    def exists(self, table: str, key: str) -> bool:
        return self.get(table, key) is not None

    def iterate_range(self, table: str, prefix: str = "",
                      start_after: str = "", limit=None):
        if table not in self._COW_TABLES:
            return self._store.iterate_range(table, prefix, start_after,
                                             limit)
        merged: dict[str, dict] = {}
        floor = start_after or ""
        for s in self._snaps:
            op = self._okey(s["snap_id"], table, prefix)
            head = len(self._okey(s["snap_id"], table, ""))
            for k, v in self._store.iterate("keys", op):
                if k[head:] > floor:
                    merged.setdefault(k[head:], v)
        # the overlays are O(changes); the live scan stays windowed for
        # walk_files_paged's paging, over-fetched by the overlay's size
        # (overlay entries can hide live rows and add rows)
        live_limit = None if limit is None else limit + len(merged)
        for k, v in self._store.iterate_range(table, prefix,
                                              start_after=floor,
                                              limit=live_limit):
            merged.setdefault(k, v)
        out = [(k, merged[k]) for k in sorted(merged)
               if not is_absent_marker(merged[k])]
        return out[:limit] if limit is not None else out

    def iterate(self, table: str, prefix: str = ""):
        yield from self.iterate_range(table, prefix)


class SnapshotManager:
    def __init__(self, om):
        self.om = om

    def create_snapshot(self, volume: str, bucket: str,
                        name: str) -> SnapshotInfo:
        """Through the replicated request, so every replica holds the
        same chain."""
        return SnapshotInfo(**self.om.submit(
            CreateSnapshot(volume, bucket, name)))

    def list_snapshots(self, volume: str, bucket: str) -> list[SnapshotInfo]:
        out = [SnapshotInfo(**v) for _, v in self.om.store.iterate(
            "open_keys", f"/.snapmeta/{volume}/{bucket}/")]
        return sorted(out, key=lambda s: s.created)

    def get_snapshot(self, volume: str, bucket: str,
                     name: str) -> SnapshotInfo:
        v = self.om.store.get("open_keys",
                              snapmeta_key(volume, bucket, name))
        if v is None:
            raise OMError(SNAPSHOT_NOT_FOUND, name)
        return SnapshotInfo(**v)

    def delete_snapshot(self, volume: str, bucket: str, name: str) -> None:
        self.om.submit(DeleteSnapshot(volume, bucket, name))

    # ------------------------------------------------------------- reads
    def _chain_from(self, volume: str, bucket: str,
                    snap_id: str) -> list[dict]:
        """The snapshots from `snap_id` (inclusive) to the newest, oldest
        first: the copy-on-write read's walk."""
        snaps = bucket_snapshots(self.om.store, volume, bucket)
        idx = next(i for i, s in enumerate(snaps)
                   if s["snap_id"] == snap_id)
        return snaps[idx:]

    def _value_at(self, volume: str, bucket: str, info: SnapshotInfo,
                  key: str) -> Optional[dict]:
        """The key's row as of snapshot `info` (None: it did not exist).
        A materialized snapshot's own rows are its row set; a
        copy-on-write one resolves to the oldest overlay entry among the
        snapshots >= it, else the live row (copy-on-write snapshots are
        newer than every materialized one of a chain, so the walk never
        crosses kinds)."""
        store = self.om.store
        if not info.cow:
            return store.get(
                "keys", f"{snap_prefix(volume, bucket, info.snap_id)}/{key}")
        for s in self._chain_from(volume, bucket, info.snap_id):
            v = store.get(
                "keys", f"{snap_prefix(volume, bucket, s['snap_id'])}/{key}")
            if v is not None:
                return None if is_absent_marker(v) else v
        return store.get("keys", f"/{volume}/{bucket}/{key}")

    def _fso_view(self, volume: str, bucket: str,
                  info: SnapshotInfo) -> SnapshotStoreView:
        return SnapshotStoreView(
            self.om.store, volume, bucket,
            self._chain_from(volume, bucket, info.snap_id))

    @staticmethod
    def _fso_row(entry: dict) -> dict:
        """A walk or status entry as a snapshot row: path-named, without
        the tree's fields."""
        return {k: v for k, v in entry.items() if k not in ("type", "path")}

    def list_keys(self, volume: str, bucket: str, name: str) -> list[dict]:
        info = self.get_snapshot(volume, bucket, name)
        store = self.om.store
        if info.cow and info.fso:
            view = self._fso_view(volume, bucket, info)
            return [self._fso_row(e)
                    for e in fso.walk_files_paged(view, volume, bucket)]
        if not info.cow:
            prefix = snap_prefix(volume, bucket, info.snap_id) + "/"
            return [v for _, v in store.iterate("keys", prefix)]
        # the oldest overlay >= this snapshot wins; the live table fills
        # the never-mutated rest
        merged: dict[str, dict] = {}
        for s in self._chain_from(volume, bucket, info.snap_id):
            p = snap_prefix(volume, bucket, s["snap_id"]) + "/"
            for k, v in store.iterate("keys", p):
                merged.setdefault(k[len(p):], v)
        base = f"/{volume}/{bucket}/"
        for k, v in store.iterate("keys", base):
            if not k.startswith("/.snap"):
                merged.setdefault(k[len(base):], v)
        return [merged[k] for k in sorted(merged)
                if not is_absent_marker(merged[k])]

    def lookup_key(self, volume: str, bucket: str, name: str,
                   key: str) -> dict:
        info = self.get_snapshot(volume, bucket, name)
        if info.cow and info.fso:
            view = self._fso_view(volume, bucket, info)
            try:
                st = fso.lookup_file(view, volume, bucket, key)
            except OMError:
                raise OMError(KEY_NOT_FOUND, f"{key}@snapshot:{name}")
            return self._fso_row(st)
        v = self._value_at(volume, bucket, info, key)
        if v is None:
            raise OMError(KEY_NOT_FOUND, f"{key}@snapshot:{name}")
        return v

    # -------------------------------------------------------------- diff
    @staticmethod
    def _key_sig(v: dict) -> tuple:
        return (v["size"], v.get("modified"), v.get("block_groups"))

    @staticmethod
    def _pair_renames(deleted: dict, added: dict
                      ) -> tuple[list, list, list]:
        """Pair deleted and added rows of one object id into renames:
        (added names, deleted names, [source, target] pairs). Rows
        without an object id stay plain adds and deletes."""
        by_id = {v.get("object_id"): n
                 for n, v in deleted.items() if v.get("object_id")}
        renamed, still_added = [], []
        gone = set(deleted)
        for n in sorted(added):
            src = by_id.get(added[n].get("object_id"))
            if src is not None and src in gone:
                renamed.append([src, n])
                gone.discard(src)
            else:
                still_added.append(n)
        return still_added, sorted(gone), sorted(renamed)

    def _compare_names(self, volume: str, bucket: str, names: set[str],
                       old_info: SnapshotInfo,
                       new_info: Optional[SnapshotInfo]) -> dict:
        """The diff restricted to `names`, the only keys that can have
        changed between the two points."""
        base = f"/{volume}/{bucket}/"
        added_v, deleted_v, modified = {}, {}, []
        for name in sorted(names):
            ov = self._value_at(volume, bucket, old_info, name)
            nv = (self._value_at(volume, bucket, new_info, name)
                  if new_info is not None
                  else self.om.store.get("keys", base + name))
            if ov is None and nv is not None:
                added_v[name] = nv
            elif ov is not None and nv is None:
                deleted_v[name] = ov
            elif ov is not None and nv is not None \
                    and self._key_sig(ov) != self._key_sig(nv):
                modified.append(name)
            # both None: created and deleted inside the window
        added, deleted, renamed = self._pair_renames(deleted_v, added_v)
        return {"added": added, "deleted": deleted, "modified": modified,
                "renamed": renamed}

    def _incremental_diff(self, volume: str, bucket: str,
                          old_info: SnapshotInfo,
                          new_info: Optional[SnapshotInfo]
                          ) -> Optional[dict]:
        """O(changes) from the update journal: the snapshots' markers pin
        journal positions, and only keys touched between them are
        compared. None when the journal no longer reaches back (a
        restart, an HA install, retention), or for FSO buckets, whose
        journal keys files by parent id."""
        store = self.om.store
        if self.om.bucket_info(volume, bucket).get("layout") == \
                "FILE_SYSTEM_OPTIMIZED":
            return None
        from_mark = store.snapshot_markers.get(old_info.snap_id)
        to_mark = (store.snapshot_markers.get(new_info.snap_id)
                   if new_info is not None else store.txid)
        if from_mark is None or to_mark is None or to_mark < from_mark:
            return None
        updates, _, complete = store.get_updates_since(from_mark)
        if not complete:
            return None
        base = f"/{volume}/{bucket}/"
        names: set[str] = set()
        for txid, table, key, _v in updates:
            if txid > to_mark:
                break
            if table == "keys" and key.startswith(base):
                names.add(key[len(base):])
        out = self._compare_names(volume, bucket, names, old_info, new_info)
        return {**out, "mode": "incremental", "keys_examined": len(names)}

    def _overlay_diff(self, volume: str, bucket: str,
                      old_info: SnapshotInfo,
                      new_info: Optional[SnapshotInfo]) -> Optional[dict]:
        """The keys mutated between two copy-on-write snapshots are the
        union of the overlays of [old, new): O(changes) after the journal
        is gone. None for FSO overlays (id-keyed) and reversed pairs."""
        if not old_info.cow or old_info.fso:
            return None
        if new_info is not None and new_info.created < old_info.created:
            return None
        store = self.om.store
        names: set[str] = set()
        for s in self._chain_from(volume, bucket, old_info.snap_id):
            if new_info is not None and s["snap_id"] == new_info.snap_id:
                break
            p = snap_prefix(volume, bucket, s["snap_id"]) + "/"
            for k, _v in store.iterate("keys", p):
                names.add(k[len(p):])
        out = self._compare_names(volume, bucket, names, old_info, new_info)
        return {**out, "mode": "overlay", "keys_examined": len(names)}

    def snapshot_diff(self, volume: str, bucket: str, from_snapshot: str,
                      to_snapshot: Optional[str] = None) -> dict:
        """Key diff between two snapshots, or a snapshot and the live
        bucket: {added, deleted, modified, renamed, mode}."""
        old_info = self.get_snapshot(volume, bucket, from_snapshot)
        new_info = (self.get_snapshot(volume, bucket, to_snapshot)
                    if to_snapshot is not None else None)
        out = self._incremental_diff(volume, bucket, old_info, new_info)
        if out is not None:
            return out
        out = self._overlay_diff(volume, bucket, old_info, new_info)
        if out is not None:
            return out
        old = {k["name"]: k
               for k in self.list_keys(volume, bucket, from_snapshot)}
        if to_snapshot is None:
            new = {k["name"]: k for k in self.om.list_keys(volume, bucket)
                   if not k["name"].startswith(".snap")}
        else:
            new = {k["name"]: k
                   for k in self.list_keys(volume, bucket, to_snapshot)}
        modified = sorted(n for n in set(old) & set(new)
                          if self._key_sig(old[n]) != self._key_sig(new[n]))
        added, deleted, renamed = self._pair_renames(
            {n: old[n] for n in set(old) - set(new)},
            {n: new[n] for n in set(new) - set(old)},
        )
        return {"added": added, "deleted": deleted, "modified": modified,
                "renamed": renamed, "mode": "full"}


class SnapshotDiffJobs:
    """Diffs as jobs (the SnapshotDiffManager job model): a submit answers
    IN_PROGRESS, a second submit of the same pair polls the job, and a
    DONE job serves its report in pages behind an opaque token. Jobs are
    this OM process's state. Entries are {op: RENAME|DELETE|MODIFY|ADD,
    key[, target]} in that order."""

    #: finished jobs kept before the oldest is evicted
    MAX_JOBS = 64

    def __init__(self, om):
        self.om = om
        self._lock = threading.Lock()
        self._by_key: dict[tuple, dict] = {}
        self._by_name: dict[tuple, dict] = {}
        self._by_id: dict[str, dict] = {}

    def submit(self, volume: str, bucket: str, from_snapshot: str,
               to_snapshot: Optional[str] = None) -> dict:
        mgr = self.om._snapshots()
        name_key = (volume, bucket, from_snapshot, to_snapshot or "")
        try:
            # jobs key on snapshot ids: a snapshot deleted and made again
            # under its name is another diff
            from_id = mgr.get_snapshot(volume, bucket, from_snapshot).snap_id
            # a diff against the live bucket holds for the state it ran
            # at: keyed by the current txid, a submit after writes runs
            # anew
            to_id = (mgr.get_snapshot(volume, bucket, to_snapshot).snap_id
                     if to_snapshot is not None
                     else f"live@{self.om.store.txid}")
        except OMError:
            # a snapshot is gone: a finished job's report is kept, so a
            # poll that raced the delete still gets its status
            with self._lock:
                job = self._by_name.get(name_key)
            if job is not None:
                return self._view(job)
            raise
        key = (volume, bucket, from_id, to_id)
        user, groups = self.om.current_user()
        with self._lock:
            job = self._by_key.get(key)
            if job is not None and job["status"] == "FAILED":
                job = None  # a failed job runs again on a resubmit
            if job is None:
                job = {
                    "job_id": uuid.uuid4().hex[:16],
                    "status": "IN_PROGRESS",
                    "volume": volume,
                    "bucket": bucket,
                    "from_snapshot": from_snapshot,
                    "to_snapshot": to_snapshot,
                    "created": time.time(),
                    "error": "",
                    "total": 0,
                    "mode": "",
                    "entries": [],
                }
                self._by_key[key] = job
                self._by_name[name_key] = job
                self._by_id[job["job_id"]] = job
                self._evict_locked()
                threading.Thread(
                    target=self._run,
                    args=(job, volume, bucket, from_snapshot, to_snapshot,
                          user, groups),
                    name=f"snapdiff-{job['job_id']}", daemon=True,
                ).start()
        return self._view(job)

    def _evict_locked(self) -> None:
        """Evict finished jobs, oldest first, past MAX_JOBS."""
        while len(self._by_id) > self.MAX_JOBS:
            victims = sorted((j for j in self._by_id.values()
                              if j["status"] != "IN_PROGRESS"),
                             key=lambda j: j["created"])
            if not victims:
                return
            v = victims[0]
            self._by_id.pop(v["job_id"], None)
            for m in (self._by_key, self._by_name):
                for k in [k for k, j in m.items()
                          if j["job_id"] == v["job_id"]]:
                    del m[k]

    @staticmethod
    def _view(job: dict) -> dict:
        return {k: job[k] for k in (
            "job_id", "status", "volume", "bucket", "from_snapshot",
            "to_snapshot", "created", "error", "total", "mode")}

    def _run(self, job: dict, volume: str, bucket: str, from_snapshot: str,
             to_snapshot: Optional[str], user=None, groups=()) -> None:
        try:
            # the submitter's identity: this thread has no caller bound,
            # and an unbound thread would check ACLs as the superuser
            with self.om.user_context(user, groups):
                out = self.om._snapshots().snapshot_diff(
                    volume, bucket, from_snapshot, to_snapshot)
            entries: list[dict] = []
            for src, dst in out.get("renamed", []):
                entries.append({"op": "RENAME", "key": src, "target": dst})
            for n in out.get("deleted", []):
                entries.append({"op": "DELETE", "key": n})
            for n in out.get("modified", []):
                entries.append({"op": "MODIFY", "key": n})
            for n in out.get("added", []):
                entries.append({"op": "ADD", "key": n})
            job["entries"] = entries
            job["total"] = len(entries)
            job["mode"] = out.get("mode", "")
            job["status"] = "DONE"
        except Exception as e:  # noqa: BLE001 - reported on the job
            job["error"] = str(e)
            job["status"] = "FAILED"

    def page(self, job_id: str, token: str = "",
             page_size: int = 1000) -> dict:
        job = self._by_id.get(job_id)
        if job is None:
            raise OMError(INVALID_REQUEST, f"no snapshot-diff job {job_id}")
        view = self._view(job)
        if job["status"] != "DONE":
            return {**view, "entries": [], "next_token": ""}
        try:
            off = int(token) if token else 0
        except ValueError:
            raise OMError(INVALID_REQUEST, f"bad page token {token!r}")
        if off < 0:
            raise OMError(INVALID_REQUEST, f"bad page token {token!r}")
        try:
            size = max(1, int(page_size))
        except (TypeError, ValueError):
            raise OMError(INVALID_REQUEST, f"bad page size {page_size!r}")
        entries = job["entries"][off:off + size]
        nxt = str(off + size) if off + size < job["total"] else ""
        return {**view, "entries": entries, "next_token": nxt}
