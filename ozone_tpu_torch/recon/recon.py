"""Recon: cluster observability warehouse + REST API.

Port of `ozone_tpu/recon/recon.py`: the same tasks, indexes, warehouse
schema (`recon.db`, so either package reads the other's history) and
routes. It imports neither torch nor the codec at module import: the OM
and SCM are handed in, and the codec service is peeked at inside its
view. `/api/mesh` peeks at the live mesh executor and answers with its
`stats()` (enabled, not started, with the spill knobs' echo, while this
process runs none). `/api/codec` reads the port's codec service.

Mirror of the reference's Recon service (hadoop-ozone/recon ReconServer:
an OM-metadata follower feeding aggregation tasks — ContainerKeyMapperTask,
FileSizeCountTask, NSSummaryTask — plus a passive SCM view detecting
missing/under-replicated containers, exposed over REST for operators and
the UI). Here: tasks run over a snapshot/tail of the OM store and the SCM
object's live state, materializing

  - namespace summary (volumes/buckets/keys, bytes)
  - file-size histogram (FileSizeCountTask analog)
  - container -> key mapping (ContainerKeyMapperTask analog)
  - container health: missing / under- / over-replicated (fsck view)
  - node utilization table

served as JSON endpoints on the service HTTP server (/api/...).
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import TYPE_CHECKING, Optional

from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.storage.ids import ContainerState

if TYPE_CHECKING:  # both import torch; Recon's module must not
    from ozone_tpu_torch.om.om import OzoneManager
    from ozone_tpu_torch.scm.scm import StorageContainerManager


class ReconTasks:
    """Aggregation tasks over OM metadata (ReconOmTask pipeline analog)."""

    def __init__(self, om: "OzoneManager"):
        self.om = om

    def namespace_summary(self) -> dict:
        """Namespace totals plus per-bucket heat cells — one walk serves
        both the summary tiles and the heatmap (the reference Recon
        heatmap's entity-heat view; access-frequency heat would need
        audit-fed counters, size heat is the warehouse-derivable
        equivalent)."""
        vols = self.om.list_volumes()
        out = {"volumes": len(vols), "buckets": 0, "keys": 0, "bytes": 0,
               "per_volume": {}, "heat_cells": []}
        for v in vols:
            name = v["name"]
            buckets = self.om.list_buckets(name)
            vsum = {"buckets": len(buckets), "keys": 0, "bytes": 0}
            for b in buckets:
                keys = self.om.list_keys(name, b["name"])
                nbytes = int(sum(k["size"] for k in keys))
                vsum["keys"] += len(keys)
                vsum["bytes"] += nbytes
                out["heat_cells"].append({
                    "volume": name,
                    "bucket": b["name"],
                    "keys": len(keys),
                    "bytes": nbytes,
                })
            out["buckets"] += vsum["buckets"]
            out["keys"] += vsum["keys"]
            out["bytes"] += vsum["bytes"]
            out["per_volume"][name] = vsum
        out["heat_cells"].sort(key=lambda c: -c["bytes"])
        return out

    def file_size_histogram(self) -> dict:
        """Power-of-two size buckets (FileSizeCountTask analog)."""
        buckets: dict[str, int] = {}
        for v in self.om.list_volumes():
            for b in self.om.list_buckets(v["name"]):
                for k in self.om.list_keys(v["name"], b["name"]):
                    size = max(1, k["size"])
                    exp = int(math.ceil(math.log2(size)))
                    label = f"<=2^{exp}"
                    buckets[label] = buckets.get(label, 0) + 1
        return dict(sorted(buckets.items(),
                           key=lambda kv: int(kv[0].split("^")[1])))

class TableInsights:
    """OM DB insights (the reference Recon's OM DB Insights page +
    table-insight task endpoints: row counts per table, open-key and
    pending-deletion listings with ages, so an operator can spot leaked
    open keys or a stuck purge chain without touching the OM)."""

    def __init__(self, om: "OzoneManager"):
        self.om = om

    def table_counts(self) -> dict:
        from ozone_tpu_torch.om.metadata import _TABLES

        return {t: self.om.store.count(t) for t in _TABLES}

    def open_keys(self, limit: int = 100) -> list[dict]:
        # collect ALL before sorting: the oldest (most interesting)
        # entry may sort last lexicographically, and a pre-sort limit
        # would hide exactly the stuck session the operator is hunting
        now = time.time()
        rows = []
        for k, info in self.om.store.iterate("open_keys"):
            rows.append({
                "key": k,
                "size": info.get("size", 0),
                "replication": info.get("replication"),
                "hsync": bool(info.get("hsync_client_id")),
                "age_s": round(now - info.get("created", now), 1),
            })
        rows.sort(key=lambda r: -r["age_s"])
        return rows[:limit]

    def deleted_keys(self, limit: int = 100) -> list[dict]:
        now = time.time()
        rows = []
        for k, info in self.om.store.iterate("deleted_keys"):
            # store key is <key>:<ts> (DeleteKey.apply)
            ts = None
            if ":" in k:
                try:
                    ts = float(k.rpartition(":")[2])
                except ValueError:
                    ts = None
            rows.append({
                "key": k,
                "size": info.get("size", 0),
                "blocks": len(info.get("block_groups", [])),
                "pending_s": (round(now - ts, 1)
                              if ts is not None else None),
            })
        rows.sort(key=lambda r: -(r["pending_s"] or 0))
        return rows[:limit]


class NSSummaryIndex:
    """Delta-fed per-directory namespace summaries (the reference's
    NSSummaryTask family: NSSummaryTaskWithFSO aggregates file count /
    bytes per directory object id from OM update batches; OBS/LEGACY
    buckets aggregate at bucket level). Serves du-style queries: direct
    totals per directory plus recursive totals down the subtree —
    without walking the namespace per request."""

    def __init__(self, om: "OzoneManager"):
        self.om = om
        self._txid = 0
        self.full_rebuilds = 0
        self._lock = threading.RLock()
        # FSO: (vol, bkt, object_id) -> {"files": n, "bytes": n}
        self._dir_agg: dict[tuple, dict] = {}
        # FSO structure: (vol,bkt) -> {object_id: {"name","parent_id"}}
        self._dirs: dict[tuple, dict[str, dict]] = {}
        self._children: dict[tuple, set] = {}  # (v,b,parent) -> ids
        # retirement maps: store key -> prior contribution
        self._file_at: dict[str, tuple] = {}  # -> (v,b,parent,size)
        self._dir_at: dict[str, tuple] = {}   # -> (v,b,object_id,parent)
        # OBS: (vol,bkt) -> {"files": n, "bytes": n}; key -> (v,b,size)
        self._obs_agg: dict[tuple, dict] = {}
        self._key_at: dict[str, tuple] = {}
        self._rebuild()

    # ------------------------------------------------------------ feed
    def _rebuild(self) -> None:
        with self._lock:
            for d in (self._dir_agg, self._dirs, self._children,
                      self._file_at, self._dir_at, self._obs_agg,
                      self._key_at):
                d.clear()
            self._txid = self.om.store.txid
            self.full_rebuilds += 1
            for table in ("dirs", "files", "keys"):
                for k, info in self.om.store.iterate(table):
                    self._apply(table, k, info)

    def refresh(self) -> None:
        with self._lock:
            updates, txid, complete = self.om.store.get_updates_since(
                self._txid)
            if not complete:
                self._rebuild()
                return
            for _, table, key, value in updates:
                if table in ("dirs", "files", "keys"):
                    self._apply(table, key, value)
            self._txid = txid

    @staticmethod
    def _vb(store_key: str):
        parts = store_key.split("/")
        return (parts[1], parts[2]) if len(parts) >= 3 else None

    def _apply(self, table: str, key: str, info) -> None:
        if key.startswith("/.snap"):
            return  # derived snapshot rows (journal=False)
        if table == "keys":
            if key.endswith("/"):
                return  # LEGACY directory markers are not files
            prior = self._key_at.pop(key, None)
            if prior is not None:
                v, b, sz = prior
                agg = self._obs_agg.get((v, b))
                if agg is not None:
                    agg["files"] -= 1
                    agg["bytes"] -= sz
            if info is None:
                return
            vb = self._vb(key)
            if vb is None:
                return
            sz = int(info.get("size", 0))
            agg = self._obs_agg.setdefault(vb, {"files": 0, "bytes": 0})
            agg["files"] += 1
            agg["bytes"] += sz
            self._key_at[key] = (*vb, sz)
            return
        if table == "files":
            prior = self._file_at.pop(key, None)
            if prior is not None:
                v, b, parent, sz = prior
                agg = self._dir_agg.get((v, b, parent))
                if agg is not None:
                    agg["files"] -= 1
                    agg["bytes"] -= sz
            if info is None:
                return
            vb = self._vb(key)
            if vb is None:
                return
            parent = str(info.get("parent_id", key.split("/")[3]))
            sz = int(info.get("size", 0))
            agg = self._dir_agg.setdefault(
                (*vb, parent), {"files": 0, "bytes": 0})
            agg["files"] += 1
            agg["bytes"] += sz
            self._file_at[key] = (*vb, parent, sz)
            return
        # dirs table: structural rows
        prior = self._dir_at.pop(key, None)
        if prior is not None:
            v, b, oid, parent = prior
            self._dirs.get((v, b), {}).pop(oid, None)
            self._children.get((v, b, parent), set()).discard(oid)
        if info is None:
            return
        vb = self._vb(key)
        if vb is None:
            return
        oid = str(info["object_id"])
        parent = str(info.get("parent_id", key.split("/")[3]))
        self._dirs.setdefault(vb, {})[oid] = {
            "name": info.get("name", ""), "parent_id": parent}
        self._children.setdefault((*vb, parent), set()).add(oid)
        self._dir_at[key] = (*vb, oid, parent)

    # ----------------------------------------------------------- query
    def _recursive(self, v: str, b: str, oid: str) -> dict:
        direct = self._dir_agg.get((v, b, oid), {"files": 0, "bytes": 0})
        total_f, total_b = direct["files"], direct["bytes"]
        for child in self._children.get((v, b, oid), ()):  # DFS
            sub = self._recursive(v, b, child)
            total_f += sub["total_files"]
            total_b += sub["total_bytes"]
        return {"files": direct["files"], "bytes": direct["bytes"],
                "total_files": total_f, "total_bytes": total_b}

    def du(self, path: str) -> dict:
        """du-style breakdown for /vol/bucket[/dir...]: direct and
        recursive totals plus immediate children (the reference's
        /api/v1/namespace/du)."""
        from ozone_tpu_torch.om import fso
        from ozone_tpu_torch.om.requests import OMError

        self.refresh()
        parts = [p for p in path.split("/") if p]
        with self._lock:
            if len(parts) < 2:
                # volume or root: bucket-level rollup
                out = {"path": path or "/", "children": []}
                tf = tb = 0
                for (v, b), agg in sorted(self._obs_agg.items()):
                    if parts and v != parts[0]:
                        continue
                    out["children"].append({
                        "path": f"/{v}/{b}",
                        "total_files": agg["files"],
                        "total_bytes": agg["bytes"]})
                    tf += agg["files"]
                    tb += agg["bytes"]
                fso_buckets = set(self._dirs) | {
                    (v, b) for (v, b, _) in self._dir_agg}
                for v, b in sorted(fso_buckets):
                    if parts and v != parts[0]:
                        continue
                    s = self._recursive(v, b, fso.ROOT_ID)
                    out["children"].append({
                        "path": f"/{v}/{b}",
                        "total_files": s["total_files"],
                        "total_bytes": s["total_bytes"]})
                    tf += s["total_files"]
                    tb += s["total_bytes"]
                out["total_files"], out["total_bytes"] = tf, tb
                return out
            v, b, rest = parts[0], parts[1], "/".join(parts[2:])
            from ozone_tpu_torch.om.metadata import bucket_key

            if not self.om.store.exists("buckets", bucket_key(v, b)):
                raise KeyError(path)  # typo must not read as "empty"
            if (v, b) in self._obs_agg and not rest:
                agg = self._obs_agg[(v, b)]
                return {"path": f"/{v}/{b}", "children": [],
                        "files": agg["files"], "bytes": agg["bytes"],
                        "total_files": agg["files"],
                        "total_bytes": agg["bytes"]}
            # FSO: resolve the path to a directory object id
            oid = fso.ROOT_ID
            if rest:
                try:
                    parent, missing = fso.resolve(self.om.store, v, b,
                                                  rest)
                except OMError:
                    missing = [rest]
                    parent = None
                if missing or parent is None:
                    raise KeyError(path)
                oid = parent
            out = {"path": f"/{v}/{b}" + (f"/{rest}" if rest else ""),
                   **self._recursive(v, b, oid), "children": []}
            for child in sorted(self._children.get((v, b, oid), ())):
                d = self._dirs.get((v, b), {}).get(child, {})
                s = self._recursive(v, b, child)
                out["children"].append({
                    "path": out["path"] + "/" + d.get("name", child),
                    "total_files": s["total_files"],
                    "total_bytes": s["total_bytes"]})
            return out


class ContainerKeyIndex:
    """Incrementally-maintained container -> keys index fed by OM WAL
    deltas (the reference's OMDBUpdatesHandler + ContainerKeyMapperTask:
    Recon tails OM RocksDB update batches and applies them to its own
    rocksdb copy instead of rescanning the namespace)."""

    def __init__(self, om: "OzoneManager"):
        self.om = om
        # cid -> {store_key: table}; FSO store keys are resolved to real
        # namespace paths at query time (they embed parent object ids)
        self._index: dict[int, dict[str, str]] = {}
        self._key_containers: dict[str, list[int]] = {}
        self._txid = 0
        self.full_rebuilds = 0
        self._lock = threading.RLock()
        self._rebuild()

    def _rebuild(self) -> None:
        with self._lock:
            self._index.clear()
            self._key_containers.clear()
            self._txid = self.om.store.txid
            self.full_rebuilds += 1
            for table in ("keys", "files"):
                for k, info in self.om.store.iterate(table):
                    self._apply(table, k, info)

    @staticmethod
    def _derived(key: str) -> bool:
        """Materialized snapshot rows are DERIVED state: they duplicate
        live keys under /.snapshot/ and are written with journal=False
        (the WAL delta deliberately omits them), so indexing them on a
        rebuild would leave entries the delta path can never retire."""
        return key.startswith("/.snap")

    def _apply(self, table: str, key: str, info) -> None:
        if self._derived(key):
            return
        # drop the previous mapping for this key path, then re-add
        for cid in self._key_containers.pop(key, []):
            m = self._index.get(cid)
            if m is not None:
                m.pop(key, None)
                if not m:
                    del self._index[cid]
        if info is None:
            return
        cids = []
        for g in info.get("block_groups", []):
            cid = int(g["container_id"])
            self._index.setdefault(cid, {})[key] = table
            cids.append(cid)
        if cids:
            self._key_containers[key] = cids

    def refresh(self) -> None:
        with self._lock:
            updates, txid, complete = self.om.store.get_updates_since(
                self._txid
            )
            if not complete:
                self._rebuild()
                return
            for utx, table, key, value in updates:
                if table in ("keys", "files"):
                    self._apply(table, key, value)
            self._txid = txid

    def _display_path(self, store_key: str, table: str) -> str:
        """Real namespace path for a store key: keys-table keys ARE paths;
        files-table keys are /vol/bucket/<parentId>/<name> and resolve by
        walking the dir_ids index upward (fso.py id_key layout)."""
        if table != "files":
            return store_key
        from ozone_tpu_torch.om.fso import ROOT_ID

        parts = store_key.split("/")
        if len(parts) < 5:
            return store_key
        vol, bkt, pid = parts[1], parts[2], parts[3]
        segs = ["/".join(parts[4:])]
        store = self.om.store
        while pid != ROOT_ID:
            row = store.get("dir_ids", f"/{vol}/{bkt}/{pid}")
            if row is None:
                break  # detached subtree pending purge
            segs.append(row["name"])
            pid = row["parent_id"]
        return f"/{vol}/{bkt}/" + "/".join(reversed(segs))

    def container_key_map(self) -> dict[int, list[str]]:
        self.refresh()
        with self._lock:
            snapshot = {
                cid: dict(m) for cid, m in self._index.items()
            }
        return {
            cid: sorted(
                self._display_path(k, table) for k, table in m.items()
            )
            for cid, m in snapshot.items()
        }


class ReconWarehouse:
    """Persistent stats warehouse (the reference's jOOQ/Derby SQL
    warehouse: GlobalStats / FileCountBySize / cluster-growth tables,
    schema generated in recon-codegen). Sqlite: one `stats` table of
    timestamped JSON task outputs queryable by kind."""

    def __init__(self, path):
        import sqlite3
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(p), check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS stats "
            "(id INTEGER PRIMARY KEY AUTOINCREMENT, ts REAL, kind TEXT, "
            "data TEXT)"
        )
        self._conn.execute(
            "CREATE INDEX IF NOT EXISTS stats_kind ON stats (kind, ts)"
        )
        self._conn.commit()
        self._lock = threading.Lock()

    def record(self, kind: str, data: dict) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO stats (ts, kind, data) VALUES (?, ?, ?)",
                (time.time(), kind, json.dumps(data, default=str)),
            )
            self._conn.commit()

    def history(self, kind: str, limit: int = 100) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT ts, data FROM stats WHERE kind=? "
                "ORDER BY ts DESC LIMIT ?",
                (kind, limit),
            ).fetchall()
        return [
            {"ts": ts, **json.loads(data)} for ts, data in rows
        ]

    def latest(self, kind: str):
        h = self.history(kind, limit=1)
        return h[0] if h else None

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class ReconScmView:
    """Passive SCM health view (ReconStorageContainerManagerFacade +
    fsck/ container health task analog)."""

    def __init__(self, scm: "StorageContainerManager"):
        self.scm = scm

    def container_health(self) -> dict:
        from ozone_tpu_torch.scm.replication_manager import ECReplicaCount

        missing, under, over, healthy = [], [], [], []
        for c in self.scm.containers.containers():
            if c.state in (ContainerState.DELETED, ContainerState.OPEN):
                continue
            if c.replication.type is ReplicationType.EC:
                count = ECReplicaCount(c, self.scm.nodes)
                if not count.recoverable:
                    missing.append(c.id)
                elif count.missing_indexes:
                    under.append(c.id)
                elif count.excess_indexes:
                    over.append(c.id)
                else:
                    healthy.append(c.id)
            else:
                live = len(c.replicas)
                if live == 0:
                    missing.append(c.id)
                elif live < c.replication.factor:
                    under.append(c.id)
                elif live > c.replication.factor:
                    over.append(c.id)
                else:
                    healthy.append(c.id)
        return {
            "healthy": healthy,
            "under_replicated": under,
            "over_replicated": over,
            "missing": missing,
        }

    def _rack_of(self) -> dict:
        return {n.dn_id: n.rack for n in self.scm.nodes.nodes()}

    def unhealthy_containers(self,
                             state: Optional[str] = None) -> list[dict]:
        """Per-container detail for every unhealthy container
        (reference: /api/v1/containers/unhealthy/{state} from the
        ContainerHealthTask's UnhealthyContainers table): replica
        placement, missing/excess indexes, and rack-spread
        mis-replication. `state` filters to MISSING / UNDER_REPLICATED /
        OVER_REPLICATED / MIS_REPLICATED."""
        from ozone_tpu_torch.scm.placement import RackScatterPlacement
        from ozone_tpu_torch.scm.replication_manager import ECReplicaCount

        racks = self._rack_of()
        total_racks = len(set(racks.values())) or 1
        out = []
        for c in self.scm.containers.containers():
            if c.state in (ContainerState.DELETED, ContainerState.OPEN):
                continue
            replicas = [
                {"dn": dn,
                 "index": getattr(r, "replica_index", None),
                 "rack": racks.get(dn)}
                for dn, r in sorted(c.replicas.items())
            ]
            states = []
            detail: dict = {}
            if c.replication.type is ReplicationType.EC:
                count = ECReplicaCount(c, self.scm.nodes)
                expected = c.replication.ec.all_units
                if count.missing_indexes and not count.recoverable:
                    states.append("MISSING")
                elif count.missing_indexes:
                    states.append("UNDER_REPLICATED")
                if count.excess_indexes:
                    states.append("OVER_REPLICATED")
                detail = {
                    "missing_indexes": sorted(count.missing_indexes),
                    "excess_indexes": sorted(count.excess_indexes),
                }
            else:
                expected = c.replication.factor
                live = len(c.replicas)
                if live == 0:
                    states.append("MISSING")
                elif live < expected:
                    states.append("UNDER_REPLICATED")
                elif live > expected:
                    states.append("OVER_REPLICATED")
            racks_used = len({r["rack"] for r in replicas
                              if r["rack"] is not None})
            if replicas and not RackScatterPlacement.validate(
                    racks_used, total_racks, expected):
                states.append("MIS_REPLICATED")
            if not states:
                continue
            if state is not None and state.upper() not in states:
                continue
            out.append({
                "container": c.id,
                "states": states,
                "replication": str(c.replication),
                "expected": expected,
                "actual": len(replicas),
                "racks_used": racks_used,
                "racks_expected": min(expected, total_racks),
                "replicas": replicas,
                **detail,
            })
        return out

    def pipeline_table(self) -> list[dict]:
        return [
            {
                "id": p.id,
                "replication": str(p.replication),
                "state": p.state.value,
                "nodes": list(p.nodes),
            }
            for p in self.scm.containers.pipelines()
        ]

    def node_table(self) -> list[dict]:
        return [
            {
                "dn_id": n.dn_id,
                "rack": n.rack,
                "state": n.state.value,
                "op_state": n.op_state.value,
                "capacity_bytes": n.capacity_bytes,
                "layout_version": n.layout_version,
                "used_bytes": n.used_bytes,
                "utilization": (
                    n.used_bytes / n.capacity_bytes if n.capacity_bytes else 0
                ),
            }
            for n in self.scm.nodes.nodes()
        ]


class ReconServer:
    """Recon REST API over the service HTTP server."""

    def __init__(self, om: "OzoneManager", scm: "StorageContainerManager",
                 host: str = "127.0.0.1", port: int = 0, db_path=None,
                 scan_cache_ttl_s: float = 15.0):
        self.tasks = ReconTasks(om)
        self.scm_view = ReconScmView(scm)
        self.key_index = ContainerKeyIndex(om)
        self.nssummary = NSSummaryIndex(om)
        self.insights = TableInsights(om)
        self.warehouse = (
            ReconWarehouse(db_path) if db_path is not None else None
        )
        #: optional cluster TraceCollector (daemons wire theirs in) —
        #: the slow-traces view then merges its flight recorder with
        #: the process-local one
        self.trace_collector = None
        # full-namespace-scan task outputs are served from a short TTL
        # cache: the UI polls every 10s from any number of tabs, and a
        # scan must cost at most one pass per TTL window, not one per
        # request (the reference serves these from the warehouse tables
        # its ReconTaskController refreshed, never by scanning inline)
        self._scan_cache_ttl = scan_cache_ttl_s
        self._scan_cache: dict[str, tuple[float, object]] = {}
        self._scan_lock = threading.Lock()
        from ozone_tpu_torch.utils.http_server import ServiceHttpServer

        self._base = ServiceHttpServer(
            "recon", host, port, status_provider=self.api_summary
        )
        # extend the handler routing with /api endpoints
        orig_handler = self._base._httpd.RequestHandlerClass
        recon = self

        class Handler(orig_handler):
            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                path, q = u.path, parse_qs(u.query)
                if path == "/api/nssummary":
                    try:
                        out = recon.nssummary.du(
                            q.get("path", ["/"])[0])
                    except KeyError as e:
                        self._send(404, json.dumps(
                            {"error": f"no such path {e}"}))
                        return
                    self._send(200, json.dumps(out, indent=2,
                                               default=str))
                    return
                if path == "/api/containers/unhealthy":
                    out = recon.scm_view.unhealthy_containers(
                        q.get("state", [None])[0])
                    self._send(200, json.dumps(out, indent=2,
                                               default=str))
                    return
                if path in ("/", "/ui"):
                    from ozone_tpu_torch.recon.ui import RECON_INDEX_HTML

                    self._send(200, RECON_INDEX_HTML,
                               "text/html; charset=utf-8")
                    return
                routes = {
                    "/api/namespace": lambda: recon._scan(
                        "namespace", recon.tasks.namespace_summary),
                    "/api/filesizes": lambda: recon._scan(
                        "filesizes", recon.tasks.file_size_histogram),
                    # ?id=<cid> narrows to one container (the
                    # reference's per-container key endpoint)
                    "/api/containers/keys": lambda: {
                        str(k): v
                        for k, v in recon.key_index.container_key_map()
                        .items()
                        if not q.get("id")
                        or str(k) == q["id"][0]
                    },
                    # derived from the (cached, warehouse-recorded)
                    # namespace scan: no extra OM walk in the request path
                    "/api/heatmap": lambda: {
                        "cells": recon._scan(
                            "namespace", recon.tasks.namespace_summary
                        ).get("heat_cells", [])
                    },
                    "/api/containers/health": recon.scm_view.container_health,
                    "/api/nodes": recon.scm_view.node_table,
                    "/api/pipelines": recon.scm_view.pipeline_table,
                    "/api/summary": recon.api_summary,
                    "/api/insights/tables": lambda: recon._scan(
                        "table_counts", recon.insights.table_counts),
                    "/api/insights/open_keys":
                        recon.insights.open_keys,
                    "/api/insights/deleted_keys":
                        recon.insights.deleted_keys,
                    # lifecycle sweeper panel: fencing term, cursor,
                    # last-sweep stats + live tiering counters
                    "/api/lifecycle": recon.lifecycle_view,
                    # geo-replication panel: shipper term/cursor,
                    # per-bucket rules, and WAL-head lag gauges
                    # (entries + seconds behind)
                    "/api/replication": recon.replication_view,
                    # shared codec service: batch fill ratio, queue
                    # depth, coalescing + QoS counters (the device's
                    # continuous-batching health, next to lifecycle —
                    # its main bulk consumer)
                    "/api/codec": recon.codec_view,
                    # persistent mesh executor: multi-chip dispatch,
                    # coalescing and spill accounting (the fleet
                    # reconstruction/bulk-tiering datapath's health)
                    "/api/mesh": recon.mesh_view,
                    # admission-control panel: per-hop controller
                    # knobs/in-flight plus every rejection counter
                    "/api/admission": recon.admission_view,
                    # small-object fast path: inline/needle counters,
                    # live slab census (count, dead-byte ratio) and
                    # threshold knob echo
                    "/api/smallobj": recon.smallobj_view,
                    # sharded metadata plane: this OM's shard config,
                    # the root shard map (when this OM hosts it), and
                    # the routing / 2PC / follower-read counters
                    "/api/shards": recon.shard_view,
                    # slow-request flight recorder: retained
                    # over-SLO traces; ?id=<traceId> returns the full
                    # span set + critical path for one trace
                    "/api/traces/slow": lambda: recon.traces_slow_view(
                        q.get("id", [None])[0],
                        int(q.get("limit", ["50"])[0])),
                }
                fn = routes.get(path)
                if fn is not None:
                    self._send(200, json.dumps(fn(), indent=2, default=str))
                elif path.startswith("/api/history/"):
                    if recon.warehouse is None:
                        self._send(404, '{"error": "no warehouse"}')
                        return
                    kind = path.rpartition("/")[2]
                    self._send(
                        200,
                        json.dumps(recon.warehouse.history(kind),
                                   indent=2, default=str),
                    )
                else:
                    super().do_GET()

        self._base._httpd.RequestHandlerClass = Handler

    def _scan(self, key: str, fn):
        """Run a namespace-scan task at most once per TTL window; callers
        in between get the cached output."""
        now = time.monotonic()
        with self._scan_lock:
            hit = self._scan_cache.get(key)
            if hit is not None and now - hit[0] < self._scan_cache_ttl:
                return hit[1]
        val = fn()
        with self._scan_lock:
            self._scan_cache[key] = (time.monotonic(), val)
        return val

    def traces_slow_view(self, trace_id: Optional[str] = None,
                         limit: int = 50) -> dict:
        """Slow-request flight recorder surface: newest-first summaries
        of traces retained past their per-op SLO, or — with ?id= — one
        trace's full span set and critical path. PEEKS at the
        process-local recorder (plus the daemon's TraceCollector ring
        when one is wired in); a monitoring GET never starts tracing."""
        from ozone_tpu_torch.utils.tracing import Tracer

        recorders = [Tracer.instance().recorder]
        if self.trace_collector is not None:
            recorders.append(self.trace_collector.recorder)
        if trace_id:
            for r in recorders:
                entry = r.trace(trace_id)
                if entry is not None:
                    return entry
            return {"error": f"trace {trace_id} not retained"}
        out, seen = [], set()
        for r in recorders:
            for e in r.slow(limit):
                if e["traceId"] not in seen:
                    seen.add(e["traceId"])
                    out.append(e)
        out.sort(key=lambda e: e["start"], reverse=True)
        return {"traces": out[:limit]}

    def codec_view(self) -> dict:
        """Shared codec service snapshot for the dashboard panel:
        fill/coalescing ratios derived from the counters plus live
        queue depth and knob echo (codec/service.stats). PEEKS at the
        singleton — a monitoring GET must never be the thing that
        spawns the device-owning dispatcher in a process that does no
        codec work."""
        from ozone_tpu_torch.codec import service as codec_service

        if not codec_service.enabled():
            return {"enabled": False}
        svc = codec_service._service
        if svc is None or not svc._running:
            return {"enabled": True, "started": False}
        return svc.stats()

    def mesh_view(self) -> dict:
        """Persistent mesh executor snapshot for the dashboard panel
        (parallel/mesh_executor.stats: dispatch, fill and coalescing
        accounting, in-flight depth, programs, the spill knobs). It peeks
        at the singleton of a module already imported, so a monitoring
        GET never starts the executor, builds a mesh or imports torch in
        a process that does no mesh work."""
        import os
        import sys

        from ozone_tpu_torch.utils.config import env_int

        if os.environ.get("OZONE_TPU_MESH", "1") == "0":
            return {"enabled": False}
        mex = sys.modules.get("ozone_tpu_torch.parallel.mesh_executor")
        ex = mex._executor if mex is not None else None
        if ex is not None and ex._running:
            return ex.stats()
        return {"enabled": True, "started": False,
                "spill_enabled": os.environ.get(
                    "OZONE_TPU_MESH_SPILL", "0") in ("1", "true", "yes",
                                                     "on"),
                "spill_watermark": max(1, env_int(
                    "OZONE_TPU_MESH_SPILL_WATERMARK", 64))}

    def admission_view(self) -> dict:
        """Overload-protection snapshot for the dashboard panel: every
        installed hop controller (knob echo, live in-flight depth,
        tenants seen, SLO shed state) plus the full ``admission``
        counter family — per-hop, per-reason rejection counts, so an
        operator can tell SHED (rejections climbing, goodput flat)
        from COLLAPSE (everything falling together). PEEKS at the
        controller cache — a monitoring GET must never be the thing
        that installs an admission controller."""
        from ozone_tpu_torch import admission
        from ozone_tpu_torch.utils.metrics import registry

        hops = {hop: ctl.snapshot()
                for hop, ctl in admission.controllers().items()}
        return {
            "enabled": any(s["enabled"] for s in hops.values()),
            "hops": hops,
            "counters": registry("admission").snapshot(),
        }

    def smallobj_view(self) -> dict:
        """Small-object fast-path snapshot for the dashboard panel: the
        ``smallobj`` counter family (inline hits, needles packed, slabs
        flushed, compaction bytes), a live slab census aggregated from
        the OM's slab rows (count, live/dead bytes, worst dead ratio —
        the compaction sweeper's backlog signal) and the threshold/knob
        echo. PEEKS at store rows and the shared registry only."""
        from ozone_tpu_torch.utils.config import env_float, env_int
        from ozone_tpu_torch.utils.metrics import registry

        store = self.tasks.om.store
        slabs = live = dead = 0
        worst = 0.0
        for _, srow in store.iterate("slabs"):
            slabs += 1
            n = int(srow.get("length", 0))
            d = int(srow.get("dead_bytes", 0))
            live += n - d
            dead += d
            if n:
                worst = max(worst, d / n)
        return {
            "counters": registry("smallobj").snapshot(),
            "slabs": {"count": slabs, "live_bytes": live,
                      "dead_bytes": dead,
                      "worst_dead_ratio": round(worst, 3)},
            "knobs": {
                "inline_max": env_int("OZONE_TPU_INLINE_MAX", 4096),
                "needle_max": env_int("OZONE_TPU_NEEDLE_MAX",
                                      256 * 1024),
                "slab_target_mib": env_float(
                    "OZONE_TPU_SLAB_TARGET_MIB", 4.0),
                "slab_linger_ms": env_float(
                    "OZONE_TPU_SLAB_LINGER_MS", 8.0),
                "dead_ratio": env_float(
                    "OZONE_TPU_SLAB_DEAD_RATIO", 0.5),
            },
        }

    def shard_view(self) -> dict:
        """Sharded metadata plane snapshot for the dashboard panel: the
        local OM's replicated `system/shard_config` row (which slots
        this ring owns, at which epoch), the root shard map when this
        OM hosts it, and the om.shard counter family (routes, moved
        rejections, cross-shard 2PC outcomes, follower-read hit/miss,
        lease renewals). PEEKS at store rows and the shared registry —
        a monitoring GET never installs or mutates shard state."""
        from ozone_tpu_torch.utils.metrics import registry

        store = self.tasks.om.store
        cfg = store.get("system", "shard_config")
        mj = store.get("system", "shard_map")
        out: dict = {"sharded": cfg is not None or mj is not None,
                     "counters": registry("om.shard").snapshot()}
        if cfg is not None:
            out["config"] = {"epoch": cfg["epoch"],
                             "shard_id": cfg["shard_id"],
                             "slot_count": cfg["slot_count"],
                             "owned_slots": len(cfg["owned"])}
        if mj is not None:
            counts: dict[str, int] = {}
            for idx in mj["slots"]:
                sid = mj["shards"][idx]
                counts[sid] = counts.get(sid, 0) + 1
            out["map"] = {"epoch": mj["epoch"],
                          "slot_count": len(mj["slots"]),
                          "slots_per_shard": counts,
                          "addresses": dict(mj.get("addresses") or {})}
        return out

    def replication_view(self) -> dict:
        """Geo-replication shipper status + per-bucket rule census for
        the dashboard panel: fencing term, WAL cursor, live counters,
        and the lag gauges (journal entries and seconds behind the WAL
        head) operators alarm on."""
        om = self.tasks.om
        out = om.geo_status()
        if "lag" not in out:
            # no shipper installed on this process (e.g. a follower):
            # derive the lag from a throwaway shipper over the same
            # store — a monitoring GET must still report how far
            # behind the cluster is
            from ozone_tpu_torch.replication_geo.shipper import (
                ReplicationShipper,
            )

            out["lag"] = ReplicationShipper(om).lag()
        buckets = []
        for bk, brow in om.store.iterate("buckets"):
            rules = brow.get("geo_replication") or []
            if rules:
                buckets.append({"bucket": bk, "rules": rules})
        out["buckets"] = buckets
        return out

    def lifecycle_view(self) -> dict:
        """Lifecycle sweeper status + per-bucket rule census for the
        dashboard panel (tiering is the main background consumer of
        device cycles, so operators watch it next to container
        health)."""
        out = self.tasks.om.lifecycle_status()
        buckets = []
        for bk, brow in self.tasks.om.store.iterate("buckets"):
            rules = brow.get("lifecycle") or []
            if rules:
                buckets.append({"bucket": bk, "rules": rules})
        out["buckets"] = buckets
        return out

    def api_summary(self) -> dict:
        health = self.scm_view.container_health()
        return {
            "ts": time.time(),
            "namespace": self._scan("namespace",
                                    self.tasks.namespace_summary),
            "containers": {k: len(v) for k, v in health.items()},
            "nodes": self.scm_view.node_table(),
        }

    def run_tasks_once(self) -> None:
        """One warehouse tick (ReconTaskController analog): refresh the
        delta-fed index and persist every task's output with a
        timestamp so operators get history, not just now. Runs the scans
        fresh and primes the serving cache with the results."""
        self.key_index.refresh()
        self.nssummary.refresh()
        ns = self.tasks.namespace_summary()
        sizes = self.tasks.file_size_histogram()
        with self._scan_lock:
            now = time.monotonic()
            self._scan_cache["namespace"] = (now, ns)
            self._scan_cache["filesizes"] = (now, sizes)
        if self.warehouse is None:
            return
        self.warehouse.record("namespace", ns)
        self.warehouse.record("filesizes", {"buckets": sizes})
        health = self.scm_view.container_health()
        self.warehouse.record(
            "container_health", {k: len(v) for k, v in health.items()}
        )
        self.warehouse.record("nodes", {"nodes": self.scm_view.node_table()})
        self.warehouse.record("table_counts", self.insights.table_counts())

    @property
    def address(self) -> str:
        return self._base.address

    def start(self) -> None:
        self._base.start()

    def stop(self) -> None:
        self._base.stop()
        if self.warehouse is not None:
            self.warehouse.close()
