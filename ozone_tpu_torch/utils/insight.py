"""Insight: per-subsystem operator introspection over RPC.

Port of `ozone_tpu/utils/insight.py` over the port's loggers and
registries, with the four partition verbs (Partition, Delay, Heal,
PartitionList) that cut, slow and restore the serving process's outbound
links through `net/partition.py`.

Mirror of the reference's `ozone insight` (hadoop-ozone/insight: per-
subsystem InsightPoint classes expose the related loggers, metrics and
configuration of om/scm/datanode components; the CLI streams component
logs by bumping log levels at runtime and reads metrics endpoints).

Here: a static registry of insight points (loggers + metrics registries
per subsystem), a bounded in-memory ring of log records captured by a
logging.Handler installed in every daemon, and an RPC service exposing
ListPoints / Metrics / Logs / SetLogLevel so the CLI can introspect any
running daemon, and Partition / Delay / Heal / PartitionList so a fault
drill can cut links between live daemons.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.storage.ids import StorageError

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
            "Partition": self._partition,
            "Delay": self._delay,
            "Heal": self._heal,
            "PartitionList": self._partition_list,
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

    # ---- network-partition injection (the blockade analog): cut and
    # restore this process's outbound links during a fault drill
    def _partition(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import partition

        m, _ = wire.unpack(req)
        if not m.get("dst"):
            raise StorageError("INVALID", "partition requires a dst address")
        partition.block(m["dst"], m.get("owner") or partition.ANY)
        return wire.pack({"blocked": partition.blocked()})

    def _delay(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import partition

        m, _ = wire.unpack(req)
        if not m.get("dst"):
            raise StorageError("INVALID", "delay requires a dst address")
        partition.delay(m["dst"], float(m.get("seconds", 0.1)),
                        m.get("owner") or partition.ANY)
        return wire.pack({"blocked": partition.blocked(),
                          "delayed": partition.delayed()})

    def _heal(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import partition

        m, _ = wire.unpack(req)
        if m.get("dst"):
            partition.heal(m["dst"], m.get("owner") or partition.ANY)
        elif m.get("owner"):
            # an owner without a dst is ambiguous: refuse rather than
            # clear every rule in the middle of a drill
            raise StorageError("INVALID", "heal: owner given without dst")
        else:
            partition.clear()
        return wire.pack({"blocked": partition.blocked()})

    def _partition_list(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import partition

        return wire.pack({"blocked": partition.blocked(),
                          "delayed": partition.delayed()})


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

    def partition(self, dst: str, owner: str = "") -> dict:
        """Cut the target process's outbound link(s) to dst."""
        return self._call("Partition", dst=dst, owner=owner)

    def delay(self, dst: str, seconds: float, owner: str = "") -> dict:
        """Add latency to the target process's calls to dst."""
        return self._call("Delay", dst=dst, seconds=seconds, owner=owner)

    def heal(self, dst: str = "", owner: str = "") -> dict:
        """Restore a cut link, or every link when dst is empty."""
        return self._call("Heal", dst=dst, owner=owner)

    def partition_list(self) -> list:
        return self._call("PartitionList")["blocked"]

    def delays(self) -> list:
        """The target process's active latency rules."""
        return self._call("PartitionList")["delayed"]

    def close(self) -> None:
        self._ch.close()
