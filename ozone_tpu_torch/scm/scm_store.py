"""SCM metadata persistence.

Port of `ozone_tpu/scm/scm_store.py` (the reference's SCM RocksDB
metadata store: containers, pipelines and sequence ids persist; replicas
are soft state rebuilt from datanode full container reports). Sqlite,
the reference's schema: container rows and the monotonic id counters
(persisted before use, so a restart never reissues an id) and the
pipeline id floor; `load` also reads the node operational states and
service-state rows the reference writes, so either package opens a
store the other wrote. The writers of those two rows wait for the
decommission and balancer slices.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from pathlib import Path


class ScmStore:
    def __init__(self, path):
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(p), check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS containers "
            "(id INTEGER PRIMARY KEY, data TEXT)"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v TEXT)"
        )
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.commit()
        self._lock = threading.Lock()

    def save_container(self, row: dict, counters: tuple[int, int]) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO containers VALUES (?, ?)",
                (row["id"], json.dumps(row)),
            )
            self._conn.execute(
                "INSERT OR REPLACE INTO meta VALUES ('counters', ?)",
                (json.dumps(list(counters)),),
            )
            self._conn.commit()

    def load(self) -> dict:
        with self._lock:
            rows = self._conn.execute(
                "SELECT data FROM containers ORDER BY id"
            ).fetchall()
            meta = self._conn.execute(
                "SELECT v FROM meta WHERE k='counters'"
            ).fetchone()
            ops = self._conn.execute(
                "SELECT v FROM meta WHERE k='node_op_states'"
            ).fetchone()
            pidf = self._conn.execute(
                "SELECT v FROM meta WHERE k='pipeline_floor'"
            ).fetchone()
        counters = json.loads(meta[0]) if meta else [1, 1]
        with self._lock:
            svc = self._conn.execute(
                "SELECT v FROM meta WHERE k='service_states'"
            ).fetchone()
        return {
            "containers": [json.loads(r[0]) for r in rows],
            "next_container_id": counters[0],
            "next_local_id": counters[1],
            "pipeline_floor": json.loads(pidf[0]) if pidf else 1,
            "node_op_states": json.loads(ops[0]) if ops else {},
            "service_states": json.loads(svc[0]) if svc else {},
        }

    def save_counters(self, counters: tuple[int, int],
                      pipeline_floor: int | None = None) -> None:
        """Durably raise the id floors WITHOUT a container row — the
        commit-first range reservations (SequenceIdGenerator analog,
        server-scm ha/SequenceIdGenerator.java:52-84) persist their
        raised floor the moment the record applies, so a restart can
        never re-issue an id from a range already handed to a leader."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO meta VALUES ('counters', ?)",
                (json.dumps(list(counters)),),
            )
            if pipeline_floor is not None:
                self._conn.execute(
                    "INSERT OR REPLACE INTO meta VALUES "
                    "('pipeline_floor', ?)",
                    (json.dumps(int(pipeline_floor)),),
                )
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
