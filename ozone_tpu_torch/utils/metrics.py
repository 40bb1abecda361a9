"""Minimal metrics: named counters and latency histograms.

A trimmed copy of `ozone_tpu/utils/metrics.py` holding only what the
port's datanode records (counters and a timing histogram); no gauges,
exporters or exemplars yet.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


#: log-spaced latency bucket bounds in seconds (100 us .. 10 s)
DEFAULT_BUCKETS = tuple(1e-4 * (10 ** (i / 4)) for i in range(21))


class Histogram:
    """Bucketed latency distribution (Prometheus histogram semantics)."""

    def __init__(self, bounds: Optional[tuple[float, ...]] = None):
        self.bounds: tuple[float, ...] = tuple(bounds or DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def observe(self, seconds: float) -> None:
        idx = next((i for i, b in enumerate(self.bounds) if seconds <= b),
                   len(self.bounds))
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += seconds

    @contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)


class MetricsRegistry:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram())
