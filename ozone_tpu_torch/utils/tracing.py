"""Minimal tracer: named spans with their durations.

A trimmed copy of `ozone_tpu/utils/tracing.py` keeping the surface the
port's writer calls (`Tracer.instance().span(name, **tags)`); spans keep
name, tags, start and duration in a bounded buffer. No trace ids,
propagation or exporters yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Span:
    name: str
    start: float
    duration: float = 0.0
    tags: dict = field(default_factory=dict)


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

    @contextmanager
    def span(self, name: str, **tags):
        s = Span(name, time.time(), tags=dict(tags))
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.duration = time.perf_counter() - t0
            with self._lock:
                self.spans.append(s)

    def traces(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            out = list(self.spans)
        return [s for s in out if name is None or s.name == name]
