"""Per-service HTTP endpoint: prometheus metrics, status, config, insight.

Port of `ozone_tpu/utils/http_server.py` (the standard library's HTTP
server; the endpoints and their answers are the reference's).

Capability mirror of the reference's BaseHttpServer + PrometheusMetricsSink
(hadoop-hdds/framework hdds/server/http/ — on-by-default /prom endpoint,
docs Observability.md:32), with the `ozone insight`-style introspection
endpoints (/metrics JSON snapshot, /conf, /logs level control;
hadoop-ozone/insight exposes the same triple per component).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from ozone_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger(__name__)


def sample_stacks(duration_s: float = 1.0,
                  interval_s: float = 0.01) -> str:
    """Sampling profiler over sys._current_frames (the ProfileServlet /
    async-profiler analog, hadoop-hdds/framework http/ProfileServlet.java):
    samples every thread's stack for `duration_s` and emits
    flamegraph-collapsed lines `frame;frame;frame count` — feed straight
    into speedscope / flamegraph.pl."""
    import sys
    import time
    import traceback
    from collections import Counter

    counts: Counter = Counter()
    deadline = time.monotonic() + duration_s
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = traceback.extract_stack(frame)
            key = ";".join(
                f"{f.name} ({f.filename.rsplit('/', 1)[-1]}:{f.lineno})"
                for f in stack
            )
            counts[key] += 1
        time.sleep(interval_s)
    return "\n".join(f"{k} {v}" for k, v in counts.most_common())


def thread_dump() -> str:
    """jstack-style dump of every live thread (the /stacks servlet)."""
    import sys
    import traceback

    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in frames.items():
        t = by_id.get(tid)
        out.append(f'Thread "{t.name if t else tid}" '
                   f"daemon={getattr(t, 'daemon', '?')}:")
        out.extend("    " + ln.strip()
                   for ln in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


class ServiceHttpServer:
    def __init__(self, service_name: str, host: str = "127.0.0.1",
                 port: int = 0,
                 status_provider: Optional[Callable[[], dict]] = None,
                 config_provider: Optional[Callable[[], dict]] = None,
                 reconfig=None):
        self.service_name = service_name
        self.status_provider = status_provider or (lambda: {})
        self.config_provider = config_provider or (lambda: {})
        #: utils/config.ReconfigurationHandler wired by the daemon; the
        #: /reconfig endpoints 404 without one
        self.reconfig = reconfig
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, body: str,
                      ctype: str = "application/json") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/prom":
                    self._send(200, metrics_mod.prometheus_text(),
                               "text/plain; version=0.0.4")
                elif u.path == "/metrics":
                    with metrics_mod._all_lock:
                        regs = dict(metrics_mod._all_registries)
                    snap = {name: reg.snapshot()
                            for name, reg in regs.items()}
                    self._send(200, json.dumps(snap, indent=2))
                elif u.path == "/status":
                    self._send(200, json.dumps(outer.status_provider(),
                                               indent=2, default=str))
                elif u.path == "/conf":
                    self._send(200, json.dumps(outer.config_provider(),
                                               indent=2, default=str))
                elif u.path == "/logLevel":
                    q = parse_qs(u.query)
                    name = q.get("log", [""])[0]
                    level = q.get("level", [""])[0]
                    if name and level:
                        logging.getLogger(name).setLevel(level.upper())
                        self._send(200, json.dumps({"log": name,
                                                    "level": level}))
                    else:
                        self._send(400, json.dumps(
                            {"error": "need ?log=<name>&level=<level>"}))
                elif u.path == "/prof":
                    # sampling profiler (ProfileServlet analog): collapsed
                    # flamegraph stacks over ?duration=S&interval=S
                    q = parse_qs(u.query)
                    try:
                        dur = min(float(q.get("duration", ["1"])[0]), 30.0)
                        iv = max(float(q.get("interval", ["0.01"])[0]),
                                 0.001)
                    except ValueError as e:
                        self._send(400, json.dumps({"error": str(e)}))
                        return
                    self._send(200, sample_stacks(dur, iv), "text/plain")
                elif u.path == "/stacks":
                    self._send(200, thread_dump(), "text/plain")
                elif u.path == "/reconfig/properties":
                    if outer.reconfig is None:
                        self._send(404, json.dumps(
                            {"error": "no reconfiguration handler"}))
                    else:
                        self._send(200, json.dumps(
                            outer.reconfig.properties(), indent=2,
                            default=str))
                elif u.path == "/reconfig":
                    q = parse_qs(u.query)
                    key = q.get("key", [""])[0]
                    value = q.get("value", [""])[0]
                    if outer.reconfig is None:
                        self._send(404, json.dumps(
                            {"error": "no reconfiguration handler"}))
                    elif not key:
                        self._send(400, json.dumps(
                            {"error": "need ?key=<k>&value=<v>"}))
                    else:
                        try:
                            self._send(200, json.dumps(
                                outer.reconfig.reconfigure(key, value),
                                default=str))
                        except (KeyError, ValueError) as e:
                            self._send(400, json.dumps({"error": str(e)}))
                else:
                    self._send(404, json.dumps({"error": "not found",
                                                "endpoints": [
                                                    "/prom", "/metrics",
                                                    "/status", "/conf",
                                                    "/logLevel", "/prof",
                                                    "/stacks",
                                                    "/reconfig",
                                                    "/reconfig/properties",
                                                ]}))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"http-{self.service_name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:  # shutdown() waits for serve_forever
            self._httpd.shutdown()
        self._httpd.server_close()
