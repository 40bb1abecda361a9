"""Distributed tracing: spans with cross-RPC propagation, slow-trace
retention and a cluster collector.

Port of `ozone_tpu/utils/tracing.py` (the reference's TracingUtil: a
span per operation, its context carried on every RPC as "traceid:spanid"
in the call header). Spans keep their trace and parent ids, name, tags,
events, start and duration in a bounded buffer; `span(name, **tags)`,
`event(name, **attrs)` on the current span, and `inject` / `activate`,
which carry a span's context onto a pool thread. A finished root offers
its local trace to the tail-based `FlightRecorder`, which pins it with
its `critical_path` (stage -> micros, summing to the root's duration)
when the root exceeded its per-op SLO (OZONE_TPU_TRACE_SLO_<OP>_MS, else
OZONE_TPU_TRACE_SLO_MS, 1000 ms). A `SpanExporter` ships finished spans
in batches every 2 s to the metadata daemon's `TraceCollector` over the
`ozone.tpu.Tracing` RPC service (or straight into an in-process
collector), which assembles them across services into one trace per id
and keeps its own flight recorder (`trace slow|show`, Recon's
`/api/traces/slow`). Export is lossy by design: a bounded queue, and a
batch the collector cannot take is dropped.
"""

from __future__ import annotations

import random
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

_local = threading.local()


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start: float
    duration: float = 0.0
    tags: dict = field(default_factory=dict)
    #: point-in-time annotations ({"t", "name", ...attrs})
    events: list = field(default_factory=list)


class Tracer:
    """Process-wide tracer with a bounded span buffer."""

    _instance: Optional["Tracer"] = None
    _instance_lock = threading.Lock()

    def __init__(self, max_spans: int = 10_000, sample_rate: float = 1.0):
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self.sample_rate = sample_rate
        self._lock = threading.Lock()
        #: filled by an attached SpanExporter; None = local-only mode
        self._export_q: Optional[deque] = None
        #: tail-based slow-trace retention (per-op SLO, env-tunable)
        self.recorder = FlightRecorder()

    @classmethod
    def instance(cls) -> "Tracer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @staticmethod
    def _new_id() -> str:
        return f"{random.getrandbits(64):016x}"

    def current(self) -> Optional[Span]:
        return getattr(_local, "span", None)

    @contextmanager
    def span(self, name: str, child_of: Optional[str] = None, **tags):
        """Start a span; `child_of` is a context string ("traceid:spanid")
        from a remote caller."""
        parent = self.current()
        if child_of:
            trace_id, parent_id = (child_of.split(":") + [""])[:2]
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = self._new_id(), ""
        s = Span(trace_id, self._new_id(), parent_id, name, time.time(),
                 tags=dict(tags))
        _local.span = s
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.duration = time.perf_counter() - t0
            _local.span = parent
            self._finish(s)

    def _finish(self, s: Span) -> None:
        if self.sample_rate >= 1.0 or random.random() < self.sample_rate:
            with self._lock:
                self.spans.append(s)
                if self._export_q is not None:
                    self._export_q.append(s)
            if not s.parent_id and \
                    s.duration >= self.recorder.slo_s(s.name):
                # the root finishes last: the whole local trace is in the
                # buffer, so tail-based retention can decide now (the
                # SLO is checked first: collecting the trace scans the
                # whole buffer)
                self.recorder.offer(s, self.traces(trace_id=s.trace_id))

    def record_span(self, name: str, *, child_of: str = "",
                    start: float, duration: float, span_id: str = "",
                    **tags) -> Span:
        """Record an interval measured on another thread as a finished
        span: the codec service's dispatcher closes a submission's queue
        wait and dispatch on behalf of the submitting operation, so no
        `span` context can bracket them. `child_of` is an `inject`
        context; without one the span joins the current trace."""
        if child_of:
            trace_id, parent_id = (child_of.split(":") + [""])[:2]
        else:
            cur = self.current()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = self._new_id(), ""
        s = Span(trace_id, span_id or self._new_id(), parent_id, name,
                 start, duration, tags=dict(tags))
        self._finish(s)
        return s

    def event(self, name: str, **attrs) -> None:
        """Annotate the current span (no-op outside any span): hedge,
        breaker and deadline decisions show why a path was taken."""
        s = self.current()
        if s is not None:
            s.events.append({"t": time.time(), "name": name, **attrs})

    @contextmanager
    def activate(self, ctx: str):
        """Re-establish a trace context ("traceid:spanid", from `inject`)
        on a worker thread: the span stack is thread-local, so pool
        workers carry the submitter's context explicitly."""
        if not ctx:
            yield
            return
        tid, sid = (ctx.split(":") + [""])[:2]
        prev = self.current()
        # context holder only: never finished, never recorded
        _local.span = Span(tid, sid, "", "<activated>", time.time())
        try:
            yield
        finally:
            _local.span = prev

    def inject(self) -> str:
        """The current context as a string; empty when not tracing."""
        s = self.current()
        return f"{s.trace_id}:{s.span_id}" if s else ""

    def current_trace_id(self) -> str:
        s = self.current()
        return s.trace_id if s else ""

    def traces(self, name: Optional[str] = None,
               trace_id: Optional[str] = None) -> list[Span]:
        """Buffered spans, of one name and/or one trace."""
        with self._lock:
            out = list(self.spans)
        return [s for s in out
                if (name is None or s.name == name)
                and (not trace_id or s.trace_id == trace_id)]

    def export_json(self) -> list[dict]:
        return [span_json(s) for s in self.traces()]


def span_json(s: Span, service: str = "") -> dict:
    return {
        "traceId": s.trace_id,
        "spanId": s.span_id,
        "parentId": s.parent_id,
        "name": s.name,
        "start": s.start,
        "durationMs": round(s.duration * 1e3, 3),
        "tags": s.tags,
        **({"events": list(s.events)} if s.events else {}),
        **({"service": service} if service else {}),
    }


def critical_path(spans: list[dict]) -> list[dict]:
    """Reduce a trace to ordered (stage, micros) wall-clock attribution.

    Every instant of the root span's duration is attributed to exactly
    one span: a parent keeps the time no child covers, overlapping
    siblings are swept first-started-first so parallel hops (hedges,
    fan-out) never double-count. Output is aggregated by span name,
    ordered by first occurrence; the micros sum equals the root span's
    duration by construction."""
    spans = [s for s in spans if s.get("spanId")]
    if not spans:
        return []
    ids = {s["spanId"] for s in spans}
    children: dict[str, list[dict]] = {}
    roots = []
    for s in spans:
        pid = s.get("parentId", "")
        if pid and pid in ids:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    root = min(roots or spans, key=lambda s: s["start"])
    stages: dict[str, list] = {}  # name -> [seconds, first_start]

    def visit(s: dict, w0: float, w1: float) -> None:
        kids = sorted(children.get(s["spanId"], []),
                      key=lambda c: c["start"])
        cur = w0
        consumed = 0.0
        for c in kids:
            c0 = max(c["start"], cur)
            c1 = min(c["start"] + c.get("durationMs", 0.0) / 1e3, w1)
            if c1 <= c0:
                continue
            visit(c, c0, c1)
            consumed += c1 - c0
            cur = c1
        st = stages.setdefault(s["name"], [0.0, w0])
        st[0] += max(0.0, (w1 - w0) - consumed)
        st[1] = min(st[1], w0)

    visit(root, root["start"],
          root["start"] + root.get("durationMs", 0.0) / 1e3)
    return [
        {"stage": name, "micros": int(round(sec * 1e6))}
        for name, (sec, _first) in sorted(stages.items(),
                                          key=lambda kv: kv[1][1])
    ]


class FlightRecorder:
    """Tail-based slow-trace retention: any trace whose ROOT span
    exceeds its per-op SLO is pinned — with its critical path — into a
    bounded ring, surviving the span buffer / collector LRU. The
    always-on flight recorder that answers "where did that P99 PUT
    spend its time" after the fact (tail sampling, not head sampling)."""

    def __init__(self, max_traces: int = 0):
        from collections import OrderedDict

        from ozone_tpu_torch.utils.config import env_int

        self.max_traces = max_traces or env_int(
            "OZONE_TPU_TRACE_SLOW_RING", 64)
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def slo_s(op: str) -> float:
        """Per-op SLO threshold: OZONE_TPU_TRACE_SLO_<OP>_MS (op is the
        root span name, uppercased, non-alnum -> _), falling back to
        OZONE_TPU_TRACE_SLO_MS (default 1000 ms). Read live so
        operators can retune a running daemon's env between restarts
        and tests can tighten it per-case."""
        from ozone_tpu_torch.utils.config import env_float

        default = env_float("OZONE_TPU_TRACE_SLO_MS", 1000.0)
        key = re.sub(r"[^A-Za-z0-9]+", "_", op).strip("_").upper()
        return env_float(f"OZONE_TPU_TRACE_SLO_{key}_MS", default) / 1e3

    def offer(self, root, spans: list) -> bool:
        """Retain the trace if its root exceeded the op's SLO. `root`
        and `spans` may be Span objects or span_json dicts."""
        rj = span_json(root) if isinstance(root, Span) else root
        if rj.get("durationMs", 0.0) / 1e3 < self.slo_s(rj["name"]):
            return False
        sj = [span_json(s) if isinstance(s, Span) else s for s in spans]
        entry = {
            "traceId": rj["traceId"],
            "root": rj["name"],
            "start": rj["start"],
            "durationMs": rj["durationMs"],
            "sloMs": round(self.slo_s(rj["name"]) * 1e3, 3),
            "spans": sj,
            "criticalPath": critical_path(sj),
        }
        with self._lock:
            self._ring[rj["traceId"]] = entry
            while len(self._ring) > self.max_traces:
                self._ring.popitem(last=False)
        return True

    def append(self, trace_id: str, spans: list[dict]) -> None:
        """Late span arrivals for an already-pinned trace (collector
        assembly is cross-service and out of order)."""
        with self._lock:
            e = self._ring.get(trace_id)
            if e is None:
                return
            e["spans"].extend(spans)
            e["criticalPath"] = critical_path(e["spans"])

    def is_pinned(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._ring

    def slow(self, limit: int = 50) -> list[dict]:
        """Newest-first summaries of retained slow traces."""
        with self._lock:
            entries = list(self._ring.values())[-limit:]
        return [
            {k: e[k] for k in
             ("traceId", "root", "start", "durationMs", "sloMs")}
            | {"spans": len(e["spans"])}
            for e in reversed(entries)
        ]

    def trace(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            e = self._ring.get(trace_id)
            return None if e is None else {
                **e, "spans": list(e["spans"]),
                "criticalPath": list(e["criticalPath"]),
            }


TRACING_SERVICE = "ozone.tpu.Tracing"


class SpanExporter:
    """Ship finished spans to a cluster collector (the reference sends
    every span to Jaeger via the jaeger-client sender — spans here ride
    the existing gRPC plane in batches). Lossy by design: the deque is
    bounded and a down collector just drops batches; tracing must never
    backpressure the datapath."""

    def __init__(self, tracer: Tracer, service: str, address: str = "",
                 tls=None, interval_s: float = 2.0,
                 max_batch: int = 512, collector=None):
        self.tracer = tracer
        self.service = service
        self.address = address
        self.tls = tls
        #: in-process collector: the metadata server feeds its own
        #: spans straight in, no loopback RPC
        self.collector = collector
        self.interval_s = interval_s
        self.max_batch = max_batch
        self.exported = 0
        self._q: deque[Span] = deque(maxlen=10_000)
        tracer._export_q = self._q
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ch = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"trace-export-{self.service}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self.flush()
        if self._ch is not None:
            self._ch.close()
            self._ch = None

    def flush(self) -> None:
        """Drain and ship everything pending (one batch per call chunk);
        errors drop the batch (collector down != datapath problem)."""
        from ozone_tpu_torch.net import wire as _wire

        batch = []
        while self._q and len(batch) < self.max_batch:
            s = self._q.popleft()
            if TRACING_SERVICE in s.name:
                continue  # never trace the tracing plane itself
            batch.append(s)
        if not batch:
            return
        if self.collector is not None:
            self.collector.add(self.service,
                               [span_json(s) for s in batch])
            self.exported += len(batch)
            return
        try:
            if self._ch is None:
                from ozone_tpu_torch.net.rpc import RpcChannel

                self._ch = RpcChannel(self.address, tls=self.tls,
                                      traced=False)
            self._ch.call(TRACING_SERVICE, "Report", _wire.pack({
                "service": self.service,
                "spans": [span_json(s) for s in batch],
            }))
            self.exported += len(batch)
        except Exception:
            # reconnect next round; spans already popped are dropped
            if self._ch is not None:
                try:
                    self._ch.close()
                except Exception:
                    pass
                self._ch = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()


class TraceCollector:
    """Cluster-wide trace assembly (the Jaeger-collector role): every
    daemon's exporter reports finished spans here; queries see ONE
    trace stitched across services. Bounded LRU over trace ids."""

    def __init__(self, server=None, max_traces: int = 2000):
        from collections import OrderedDict

        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self.max_traces = max_traces
        self._lock = threading.Lock()
        #: cluster-side flight recorder: roots reported over the wire
        #: pin their whole assembled trace past the LRU
        self.recorder = FlightRecorder()
        if server is not None:
            server.add_service(TRACING_SERVICE, {
                "Report": self._report,
                "Query": self._query,
                "Recent": self._recent,
                "Slow": self._slow,
            })

    # ------------------------------------------------------------ ingest
    def add(self, service: str, spans: list[dict]) -> None:
        slow_roots = []
        late: dict[str, list[dict]] = {}
        with self._lock:
            for sp in spans:
                tid = sp.get("traceId", "")
                if not tid:
                    continue
                sp = dict(sp)
                sp.setdefault("service", service)
                t = self._traces.get(tid)
                if t is None:
                    t = self._traces[tid] = {
                        "spans": [], "services": set(),
                        "start": sp["start"], "end": 0.0,
                    }
                    while len(self._traces) > self.max_traces:
                        self._traces.popitem(last=False)
                t["spans"].append(sp)
                t["services"].add(sp.get("service") or service)
                t["start"] = min(t["start"], sp["start"])
                t["end"] = max(t["end"],
                               sp["start"] + sp["durationMs"] / 1e3)
                if not sp.get("parentId"):
                    slow_roots.append(sp)
                elif self.recorder.is_pinned(tid):
                    late.setdefault(tid, []).append(sp)
        # tail retention outside the assembly lock: offer() re-reads the
        # trace and evaluates the SLO, never blocking concurrent Reports
        for root in slow_roots:
            self.recorder.offer(root, self.trace(root["traceId"]))
        for tid, sps in late.items():
            self.recorder.append(tid, sps)

    def _report(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import wire as _wire

        m, _ = _wire.unpack(req)
        self.add(m.get("service", ""), m.get("spans", []))
        return _wire.pack({"ok": True})

    # ------------------------------------------------------------- query
    def trace(self, trace_id: str) -> list[dict]:
        with self._lock:
            t = self._traces.get(trace_id)
            if t is not None:
                return sorted((dict(s) for s in t["spans"]),
                              key=lambda s: s["start"])
        # evicted from the LRU but pinned as slow: still answerable
        pinned = self.recorder.trace(trace_id)
        return (sorted(pinned["spans"], key=lambda s: s["start"])
                if pinned else [])

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock:
            # deep-enough copies: concurrent Report RPCs mutate the
            # per-trace spans list and services set under the lock
            items = [
                (tid, {"spans": list(t["spans"]),
                       "services": set(t["services"]),
                       "start": t["start"], "end": t["end"]})
                for tid, t in list(self._traces.items())[-limit:]
            ]
        out = []
        for tid, t in reversed(items):
            roots = [s["name"] for s in t["spans"]
                     if not s.get("parentId")]
            out.append({
                "traceId": tid,
                "spans": len(t["spans"]),
                "services": sorted(t["services"]),
                "root": roots[0] if roots else t["spans"][0]["name"],
                "start": t["start"],
                "durationMs": round((t["end"] - t["start"]) * 1e3, 3),
            })
        return out

    def _query(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import wire as _wire

        m, _ = _wire.unpack(req)
        return _wire.pack({"spans": self.trace(m.get("trace_id", ""))})

    def _recent(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import wire as _wire

        m, _ = _wire.unpack(req)
        return _wire.pack({"traces": self.recent(m.get("limit", 50))})

    def _slow(self, req: bytes) -> bytes:
        from ozone_tpu_torch.net import wire as _wire

        m, _ = _wire.unpack(req)
        tid = m.get("trace_id", "")
        if tid:
            return _wire.pack({"trace": self.recorder.trace(tid)})
        return _wire.pack(
            {"traces": self.recorder.slow(m.get("limit", 50))})


# Histogram exemplars stamp the active trace id (outlier observations
# link a scraped tail bucket to a retained slow trace); registered here
# so metrics stays import-independent of tracing.
from ozone_tpu_torch.utils import metrics as _metrics  # noqa: E402

_metrics.set_trace_id_provider(
    lambda: Tracer.instance().current_trace_id())
