"""Minimal metrics: named counters, gauges and latency histograms.

A trimmed copy of `ozone_tpu/utils/metrics.py` holding what the port's
datanode and codec service record: counters, gauges, timers (count,
total, min, max: the geo shipper's cycle seconds), and timing histograms
whose observations may carry the trace id of the operation they belong
to (the latest per bucket is kept as its exemplar), with the reference's
bucket bounds and bucket-quantile estimates.
`registry(name)` returns the process-wide registry of that name. No
exporters yet.
"""

from __future__ import annotations

import math
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


class Gauge:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v


class Timer:
    """Latency accumulator: count, total, min and max."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def update(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0


def log_buckets(lo: float = 1e-4, hi: float = 100.0,
                per_decade: int = 3) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(round(per_decade * math.log10(hi / lo)))
    return tuple(
        round(lo * (hi / lo) ** (i / n), 10) for i in range(n + 1)
    )


#: latency bucket bounds in seconds: 100 us .. 100 s, 3 per decade
DEFAULT_BUCKETS = log_buckets()


class Histogram:
    """Bucketed latency distribution (Prometheus histogram semantics)."""

    def __init__(self, bounds: Optional[tuple[float, ...]] = None):
        self.bounds: tuple[float, ...] = tuple(bounds or DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        #: bucket index -> (seconds, trace id) of its latest traced sample
        self.exemplars: dict[int, tuple[float, str]] = {}

    def observe(self, seconds: float, trace_id: str = "") -> None:
        idx = next((i for i, b in enumerate(self.bounds) if seconds <= b),
                   len(self.bounds))
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)
            if trace_id:
                self.exemplars[idx] = (seconds, trace_id)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile by linear interpolation within the
        containing bucket (what a PromQL histogram_quantile would see)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            cum = 0
            for i, c in enumerate(self._counts):
                if not c:
                    continue
                if cum + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    hi = (self.bounds[i] if i < len(self.bounds)
                          else max(self.max, lo))
                    frac = (target - cum) / c
                    return lo + (hi - lo) * frac
                cum += c
            return self.max

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

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
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._timers: dict[str, Timer] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram())

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def snapshot(self) -> dict:
        """Counter and gauge values by name, and `<name>_mean_s` of every
        timer and histogram that has observations."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timed = {**self._timers, **self._histograms}
        return {
            **{k: c.value for k, c in counters.items()},
            **{k: g.value for k, g in gauges.items()},
            **{f"{k}_mean_s": t.mean for k, t in timed.items() if t.count},
        }


_registries: dict[str, MetricsRegistry] = {}
_registries_lock = threading.Lock()


def registry(name: str) -> MetricsRegistry:
    """The process-wide registry of this name, created on first use."""
    with _registries_lock:
        r = _registries.get(name)
        if r is None:
            r = _registries[name] = MetricsRegistry(name)
        return r
