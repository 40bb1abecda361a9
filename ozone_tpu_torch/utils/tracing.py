"""Minimal tracer: named spans with their durations, events and context.

A trimmed copy of `ozone_tpu/utils/tracing.py` keeping the surface the
port's writer, reader and resilience layer call: `span(name, **tags)`,
`event(name, **attrs)` on the current span, and `inject` / `activate`,
which carry a span's context onto a pool thread. Spans keep their trace
and parent ids, name, tags, events, start and duration in a bounded
buffer. No exporters, sampling or slow-trace retention yet.
"""

from __future__ import annotations

import random
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

    def __init__(self, max_spans: int = 10_000):
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()

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
    def span(self, name: str, **tags):
        parent = self.current()
        if parent is not None:
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
            with self._lock:
                self.spans.append(s)

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
        with self._lock:
            self.spans.append(s)
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

    def traces(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            out = list(self.spans)
        return [s for s in out if name is None or s.name == name]
