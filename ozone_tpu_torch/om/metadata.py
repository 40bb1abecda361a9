"""OM metadata store: the namespace tables on sqlite with write-batched
flush.

Port of `ozone_tpu/om/metadata.py` (the reference's OmMetadataManagerImpl
tables over sqlite instead of RocksDB, and the OzoneManagerDoubleBuffer
pattern: applied requests mutate an in-memory cache at once and are
flushed to sqlite in batches; a request is acknowledged only after a
group commit covers it). The schema is the reference's, table for table,
and rows are the same JSON, so either package opens a database the other
wrote. The rolling digest of the `keys` table rides the same commits, as
in the reference. Left out for later slices: the update journal
(WAL-delta shipping to Recon and snapshot diffs), snapshot markers,
full-table export and import (HA bootstrap) and row counts.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import sqlite3
import threading
from pathlib import Path
from typing import Iterator, Optional

#: the reference's tables, all created so a database stays valid for it
_TABLES = (
    "volumes",
    "buckets",
    "keys",
    "open_keys",
    "deleted_keys",
    "dirs",
    "dir_ids",
    "files",
    "deleted_dirs",
    "multipart",
    "s3_secrets",
    "prefixes",
    "tenants",
    "tenant_access",
    "delegation_tokens",
    "dtoken_keys",
    "system",
    "slabs",
)

#: tables with a maintained rolling state digest (XOR of row hashes)
_DIGEST_TABLES = ("keys",)


def _row_hash(key: str, value: dict) -> int:
    return _row_hash_json(key, json.dumps(value, sort_keys=True))


def _row_hash_json(key: str, dumped: str) -> int:
    h = hashlib.md5()
    h.update(key.encode())
    h.update(b"\0")
    h.update(dumped.encode())
    return int.from_bytes(h.digest(), "big")


class OMMetadataStore:
    def __init__(self, db_path: Path, flush_every: int = 64):
        self._path = Path(db_path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(self._path), check_same_thread=False)
        for t in _TABLES:
            self._conn.execute(
                f"CREATE TABLE IF NOT EXISTS {t} (k TEXT PRIMARY KEY, v TEXT)"
            )
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.commit()
        self._lock = threading.RLock()
        # table -> key -> value-or-None (a tombstone): the double buffer
        self._cache: dict[str, dict[str, Optional[dict]]] = {
            t: {} for t in _TABLES
        }
        self._dirty: list[tuple[str, str, Optional[str]]] = []
        self.flush_every = flush_every
        self._txid = 0
        # group commit (flush_group): _txid doubles as the apply sequence
        self._flush_cv = threading.Condition()
        self._flushed_txid = 0
        self._flushing = False
        # atomic() nesting depth: > 0 defers the flush_every auto-flush
        self._defer = 0
        self._digests: dict[str, int] = {}
        # hash of each unflushed digested row as it was digested, keyed
        # (table, key); 0 = digested as absent. Never recomputed from the
        # cache: callers mutate fetched dicts in place before put()
        self._digest_hashes: dict[tuple[str, str], int] = {}
        for t in _DIGEST_TABLES:
            row = self._conn.execute(
                "SELECT v FROM system WHERE k=?", (f"__digest_{t}",)
            ).fetchone()
            if row is not None:
                self._digests[t] = int(json.loads(row[0])["xor"], 16)
            else:
                self._digests[t] = self._scan_digest(t)

    def _scan_digest(self, table: str) -> int:
        d = 0
        for k, v in self._conn.execute(f"SELECT k, v FROM {table}"):
            d ^= _row_hash(k, json.loads(v))
        return d

    def _digest_mutate(self, table: str, key: str,
                       dumped: Optional[str]) -> None:
        """Caller holds self._lock; `dumped` is the canonical dump of the
        new value (None = delete)."""
        if table not in self._digests:
            return
        hk = (table, key)
        old = self._digest_hashes.get(hk)
        if old is None:
            row = self._conn.execute(
                f"SELECT v FROM {table} WHERE k=?", (key,)).fetchone()
            old = _row_hash(key, json.loads(row[0])) if row else 0
        new = _row_hash_json(key, dumped) if dumped is not None else 0
        self._digests[table] ^= old ^ new
        self._digest_hashes[hk] = new

    # ------------------------------------------------------------------ CRUD
    @contextlib.contextmanager
    def atomic(self):
        """One request's mutations land in one durable batch: the
        flush_every auto-flush is deferred inside the block."""
        with self._lock:
            self._defer += 1
        try:
            yield
        finally:
            with self._lock:
                self._defer -= 1
                if not self._defer and \
                        len(self._dirty) >= self.flush_every:
                    self._flush_locked()

    def put(self, table: str, key: str, value: dict) -> None:
        # serialized at put time: the flushed row is what was digested
        # even if the caller keeps mutating the dict
        dumped = json.dumps(value, sort_keys=True)
        with self._lock:
            self._digest_mutate(table, key, dumped)
            self._cache[table][key] = value
            self._dirty.append((table, key, dumped))
            self._txid += 1
            if not self._defer and len(self._dirty) >= self.flush_every:
                self._flush_locked()

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            self._digest_mutate(table, key, None)
            self._cache[table][key] = None
            self._dirty.append((table, key, None))
            self._txid += 1
            if not self._defer and len(self._dirty) >= self.flush_every:
                self._flush_locked()

    def get(self, table: str, key: str) -> Optional[dict]:
        with self._lock:
            if key in self._cache[table]:
                return self._cache[table][key]
            row = self._conn.execute(
                f"SELECT v FROM {table} WHERE k=?", (key,)
            ).fetchone()
            return json.loads(row[0]) if row else None

    def exists(self, table: str, key: str) -> bool:
        return self.get(table, key) is not None

    def iterate(
        self, table: str, prefix: str = ""
    ) -> Iterator[tuple[str, dict]]:
        """Sorted iteration merging the cache over sqlite (prefix scan)."""
        yield from self.iterate_range(table, prefix)

    def iterate_range(
        self, table: str, prefix: str = "", start_after: str = "",
        limit: Optional[int] = None,
    ) -> list[tuple[str, dict]]:
        """Bounded sorted scan: rows under `prefix` with key >
        `start_after`, at most `limit` (None = all). The SQL window
        over-fetches by the cache's size so cached deletions can never
        displace a row out of the window; merged rows past a truncated SQL
        horizon are dropped to keep the order exact."""
        with self._lock:
            floor = start_after or ""
            cache_rows = {
                k: v
                for k, v in self._cache[table].items()
                if k.startswith(prefix) and k > floor
            }
            sql_limit = -1 if limit is None else limit + len(cache_rows)
            if floor and floor >= prefix:
                cond, bound = "k > ?", floor
            else:
                cond, bound = "k >= ?", prefix
            db_rows = self._conn.execute(
                f"SELECT k, v FROM {table} WHERE {cond} AND k < ? "
                f"ORDER BY k LIMIT ?",
                (bound, prefix + "\uffff", sql_limit),
            ).fetchall()
            merged: dict[str, Optional[dict]] = {
                k: json.loads(v) for k, v in db_rows
            }
            merged.update(cache_rows)
            out = [(k, merged[k]) for k in sorted(merged)
                   if merged[k] is not None]
            if (limit is not None and len(db_rows) == sql_limit
                    and db_rows):
                horizon = db_rows[-1][0]
                out = [kv for kv in out if kv[0] <= horizon]
            if limit is not None:
                out = out[: max(0, limit)]
            return out

    # ------------------------------------------------------------------ flush
    def flush_group(self) -> None:
        """Group commit: make everything this caller applied durable,
        batched with whatever concurrent callers applied meanwhile (one
        sqlite commit covers them all). One thread flushes; the rest wait
        for a flush that covers their apply sequence, and a caller woken
        uncovered (the flusher failed) flushes itself."""
        with self._lock:
            target = self._txid
        while True:
            with self._flush_cv:
                if self._flushed_txid >= target:
                    return
                if not self._flushing:
                    self._flushing = True
                    break
                self._flush_cv.wait(timeout=5.0)
        seq = 0
        ok = False
        try:
            with self._lock:
                seq = self._txid
                self._flush_locked()
            ok = True
        finally:
            with self._flush_cv:
                self._flushing = False
                if ok:
                    self._flushed_txid = max(self._flushed_txid, seq)
                self._flush_cv.notify_all()

    def _flush_locked(self) -> None:
        if not self._dirty:
            return
        batch, self._dirty = self._dirty, []
        cur = self._conn.cursor()
        for table, key, dumped in batch:
            if dumped is None:
                cur.execute(f"DELETE FROM {table} WHERE k=?", (key,))
            else:
                cur.execute(
                    f"INSERT OR REPLACE INTO {table} VALUES (?, ?)",
                    (key, dumped),
                )
        # digest rows ride the same commit as the rows they describe
        for t, d in self._digests.items():
            cur.execute(
                "INSERT OR REPLACE INTO system VALUES (?, ?)",
                (f"__digest_{t}", json.dumps({"xor": f"{d:032x}"})),
            )
        self._conn.commit()
        # cache entries are now durable; drop them so memory stays bounded
        for t, k, _ in batch:
            self._cache[t].pop(k, None)
            self._digest_hashes.pop((t, k), None)

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            self._conn.close()


def volume_key(volume: str) -> str:
    return f"/{volume}"


def bucket_key(volume: str, bucket: str) -> str:
    return f"/{volume}/{bucket}"


def key_key(volume: str, bucket: str, key: str) -> str:
    return f"/{volume}/{bucket}/{key}"


def slab_key(volume: str, bucket: str, slab_id: str) -> str:
    """A slab row's key: under its bucket, so it sorts with the bucket."""
    return f"/{volume}/{bucket}/{slab_id}"
