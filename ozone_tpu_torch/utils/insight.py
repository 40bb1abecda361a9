"""Insight: per-subsystem operator introspection over RPC.

Port of `ozone_tpu/utils/insight.py` over the port's loggers and
registries. Left out: the four partition verbs (Partition, Delay, Heal,
PartitionList), which need `net/partition.py` and the RPC channel's
partition checks.

Mirror of the reference's `ozone insight` (hadoop-ozone/insight: per-
subsystem InsightPoint classes expose the related loggers, metrics and
configuration of om/scm/datanode components; the CLI streams component
logs by bumping log levels at runtime and reads metrics endpoints).

Here: a static registry of insight points (loggers + metrics registries
per subsystem), a bounded in-memory ring of log records captured by a
logging.Handler installed in every daemon, and an RPC service exposing
ListPoints / Metrics / Logs / SetLogLevel so the CLI can introspect any
running daemon.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import RpcServer

SERVICE = "ozone.tpu.Insight"

# subsystem -> related loggers + metrics registries (BaseInsightPoint
# catalogs per service; reference insight/om/, scm/, datanode/)
INSIGHT_POINTS: dict[str, dict] = {
    "om.key-manager": {
        "loggers": ["ozone_tpu_torch.om.om", "ozone_tpu_torch.om.requests"],
        "metrics": ["om"],
        "description": "key create/commit/lookup path",
    },
    "om.fso": {
        "loggers": ["ozone_tpu_torch.om.fso"],
        "metrics": ["om"],
        "description": "FSO directory tree requests",
    },
    "scm.node-manager": {
        "loggers": ["ozone_tpu_torch.scm.node_manager"],
        "metrics": ["scm"],
        "description": "datanode membership + liveness",
    },
    "scm.replication-manager": {
        "loggers": ["ozone_tpu_torch.scm.replication_manager"],
        "metrics": ["scm"],
        "description": "under/over-replication control loop",
    },
    "scm.block-manager": {
        "loggers": ["ozone_tpu_torch.scm.container_manager",
                    "ozone_tpu_torch.scm.block_deletion"],
        "metrics": ["scm"],
        "description": "block allocation + deletion chain",
    },
    "datanode.dispatcher": {
        "loggers": ["ozone_tpu_torch.storage.datanode",
                    "ozone_tpu_torch.net.dn_service"],
        "metrics": ["datanode"],
        "description": "container command dispatch",
    },
    "datanode.reconstruction": {
        "loggers": ["ozone_tpu_torch.storage.reconstruction"],
        "metrics": ["datanode"],
        "description": "EC offline reconstruction",
    },
}


class RingLogHandler(logging.Handler):
    """Bounded in-memory log capture (the insight log-streaming source)."""

    _installed: Optional["RingLogHandler"] = None

    def __init__(self, capacity: int = 4096):
        super().__init__(level=logging.DEBUG)
        self.records: deque = deque(maxlen=capacity)
        self._lock2 = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001
            msg = str(record.msg)
        with self._lock2:
            self.records.append({
                "ts": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": msg,
            })

    def tail(self, n: int = 100, logger_prefix: str = "",
             level: str = "") -> list[dict]:
        want = logging.getLevelName(level.upper()) if level else 0
        if not isinstance(want, int):
            want = 0
        with self._lock2:
            records = list(self.records)
        out = []
        for r in reversed(records):
            if logger_prefix and not r["logger"].startswith(logger_prefix):
                continue
            lv = logging.getLevelName(r["level"])
            if isinstance(lv, int) and lv < want:
                continue
            out.append(r)
            if len(out) >= n:
                break
        return list(reversed(out))

    @classmethod
    def install(cls, capacity: int = 4096) -> "RingLogHandler":
        if cls._installed is None:
            h = cls(capacity)
            logging.getLogger().addHandler(h)
            cls._installed = h
        return cls._installed


class InsightService:
    """RPC surface for the insight CLI, added to any daemon's server."""

    def __init__(self, server: RpcServer, component: str):
        self.component = component
        self.ring = RingLogHandler.install()
        server.add_service(SERVICE, {
            "ListPoints": self._list_points,
            "Metrics": self._metrics,
            "Logs": self._logs,
            "SetLogLevel": self._set_log_level,
        })

    def _list_points(self, req: bytes) -> bytes:
        return wire.pack({
            "component": self.component,
            "points": INSIGHT_POINTS,
        })

    def _metrics(self, req: bytes) -> bytes:
        from ozone_tpu_torch.utils import metrics

        with metrics._all_lock:
            regs = dict(metrics._all_registries)
        return wire.pack({
            "ts": time.time(),
            "registries": {name: reg.snapshot()
                           for name, reg in regs.items()},
        })

    def _logs(self, req: bytes) -> bytes:
        m, _ = wire.unpack(req)
        return wire.pack({
            "records": self.ring.tail(
                n=int(m.get("n", 100)),
                logger_prefix=m.get("logger", ""),
                level=m.get("level", ""),
            ),
        })

    def _set_log_level(self, req: bytes) -> bytes:
        m, _ = wire.unpack(req)
        logger = logging.getLogger(m["logger"] or None)
        logger.setLevel(m["level"].upper())
        return wire.pack({"logger": m["logger"], "level": m["level"]})


class InsightClient:
    def __init__(self, address: str, tls=None):
        from ozone_tpu_torch.net.rpc import RpcChannel

        self._ch = RpcChannel(address, tls=tls)

    def _call(self, method: str, **m) -> dict:
        out, _ = wire.unpack(self._ch.call(SERVICE, method, wire.pack(m)))
        return out

    def list_points(self) -> dict:
        return self._call("ListPoints")

    def metrics(self) -> dict:
        return self._call("Metrics")

    def logs(self, n: int = 100, logger: str = "",
             level: str = "") -> list[dict]:
        return self._call("Logs", n=n, logger=logger, level=level)["records"]

    def set_log_level(self, logger: str, level: str) -> dict:
        return self._call("SetLogLevel", logger=logger, level=level)

    def close(self) -> None:
        self._ch.close()
