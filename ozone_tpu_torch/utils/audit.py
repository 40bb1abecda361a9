"""Structured audit logging.

Port of `ozone_tpu/utils/audit.py` (the same JSON record per line).
Mirror of the reference's AuditLogger (hadoop-hdds/framework
ozone/audit/AuditLogger.java): every namespace/admin operation emits a
structured record (action, params, outcome) to a dedicated logger; parsers
can consume the line format (tools/audit parser analog).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any


class AuditLogger:
    def __init__(self, component: str):
        self.component = component
        self._log = logging.getLogger(f"audit.{component}")

    def log(self, action: str, params: dict[str, Any], ok: bool = True,
            error: str = "", user: str = "root") -> None:
        safe_params = {
            k: v
            for k, v in params.items()
            if isinstance(v, (str, int, float, bool, type(None)))
        }
        record = {
            "ts": time.time(),
            "user": user,
            "action": action,
            "params": safe_params,
            "result": "SUCCESS" if ok else "FAILURE",
        }
        if error:
            record["error"] = error
        self._log.info("%s", json.dumps(record, sort_keys=True))
