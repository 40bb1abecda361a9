"""Metrics: counters, gauges, timers and latency histograms, with the
Prometheus exposition.

Port of `ozone_tpu/utils/metrics.py`. Every registry a process makes
(`registry(name)` returns the process-wide one of that name; a
constructed `MetricsRegistry` takes its name's slot too) is in the global
table that `prometheus_text()` renders, sorted, each metric with its
`# HELP` and `# TYPE` lines (the `/prom` endpoint), and that insight's
`Metrics` verb snapshots. Timing histograms use the reference's bucket
bounds and bucket-quantile estimates; an observation at or above half
the running mean keeps the trace id of the operation it belongs to as
its bucket's exemplar (OpenMetrics syntax in the exposition), given
explicitly or by the provider `utils/tracing` installs
(`set_trace_id_provider`).
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

_all_registries: dict[str, "MetricsRegistry"] = {}
_all_lock = threading.RLock()  # registry() constructs while holding it

# installed by utils/tracing at import, so that a histogram stamps the
# active trace id without metrics importing tracing
_trace_id_provider: Optional[Callable[[], str]] = None


def set_trace_id_provider(fn: Callable[[], str]) -> None:
    global _trace_id_provider
    _trace_id_provider = fn


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

    @contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.update(time.perf_counter() - t0)


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
        #: bucket index -> (seconds, trace id, unix time) of its latest
        #: traced outlier
        self.exemplars: dict[int, tuple[float, str, float]] = {}

    def observe(self, seconds: float, trace_id: str = "") -> None:
        idx = next((i for i, b in enumerate(self.bounds) if seconds <= b),
                   len(self.bounds))
        if not trace_id and _trace_id_provider is not None:
            try:
                trace_id = _trace_id_provider() or ""
            except Exception:  # noqa: BLE001 - metrics never fail a caller
                trace_id = ""
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)
            # at or above half the running mean: the tail, without a
            # quantile pass per observation
            if trace_id and seconds * 2 >= (self.total / self.count):
                self.exemplars[idx] = (seconds, trace_id, time.time())

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

    def render(self, metric: str, lines: list[str]) -> None:
        """Append the exposition lines of one histogram family."""
        with self._lock:
            counts = list(self._counts)
            exemplars = dict(self.exemplars)
            total, count = self.total, self.count
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            le = (_format_float(self.bounds[i]) if i < len(self.bounds)
                  else "+Inf")
            line = f'{metric}_bucket{{le="{le}"}} {cum}'
            ex = exemplars.get(i)
            if ex is not None:
                val, tid, ts = ex
                line += (f' # {{trace_id="{escape_label(tid)}"}} '
                         f"{_format_float(val)} {round(ts, 3)}")
            lines.append(line)
        lines.append(f"{metric}_sum {total}")
        lines.append(f"{metric}_count {count}")


def _format_float(v: float) -> str:
    s = f"{v:.10f}".rstrip("0").rstrip(".")
    return s if s else "0"


class MetricsRegistry:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._timers: dict[str, Timer] = {}
        with _all_lock:
            _all_registries[name] = self

    # A metric that exists is found without the lock (a dict read is
    # atomic) and without building a spare: hot paths look theirs up on
    # every call.
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer())
        return t

    def snapshot(self) -> dict:
        """Counter and gauge values by name, `<name>_mean_s` of every
        timer and histogram that has observations, and the histograms'
        `<name>_p50_s`, `_p95_s` and `_p99_s`."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            timed = {**self._timers, **hists}
        return {
            **{k: c.value for k, c in counters.items()},
            **{k: g.value for k, g in gauges.items()},
            **{f"{k}_mean_s": t.mean for k, t in timed.items() if t.count},
            **{f"{k}_{p}_s": v for k, h in hists.items() if h.count
               for p, v in h.percentiles().items()},
        }


def registry(name: str) -> MetricsRegistry:
    """The process-wide registry of this name, created on first use."""
    with _all_lock:
        r = _all_registries.get(name)
        if r is None:
            # constructed under the lock: the constructor takes the slot
            r = MetricsRegistry(name)
        return r


def get_registry(name: str) -> Optional[MetricsRegistry]:
    return _all_registries.get(name)


def _sanitize(s: str) -> str:
    return s.replace(".", "_").replace("-", "_")


def escape_label(v: str) -> str:
    """Escape a label value per the exposition format: backslash,
    double-quote and newline are escaped inside `label="..."`."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus exposition text of one or every registry: each metric
    renders a `# HELP` and `# TYPE` pair with a stable
    `<registry>_<name>` identifier, registries and metrics in sorted
    order so successive scrapes diff cleanly."""
    with _all_lock:
        regs = ([registry] if registry
                else [_all_registries[k] for k in sorted(_all_registries)])
    lines: list[str] = []
    for r in regs:
        base = _sanitize(r.name)
        with r._lock:
            counters = sorted(r._counters.items())
            gauges = sorted(r._gauges.items())
            timers = sorted(r._timers.items())
            hists = sorted(r._histograms.items())
        for k, c in counters:
            m = f"{base}_{_sanitize(k)}"
            lines.append(f"# HELP {m} counter {k} of registry {r.name}")
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {c.value}")
        for k, g in gauges:
            m = f"{base}_{_sanitize(k)}"
            lines.append(f"# HELP {m} gauge {k} of registry {r.name}")
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {g.value}")
        for k, t in timers:
            m = f"{base}_{_sanitize(k)}"
            lines.append(f"# HELP {m}_seconds latency summary {k} of "
                         f"registry {r.name}")
            lines.append(f"# TYPE {m}_seconds summary")
            lines.append(f"{m}_seconds_count {t.count}")
            lines.append(f"{m}_seconds_sum {t.total}")
        for k, h in hists:
            m = f"{base}_{_sanitize(k)}"
            lines.append(f"# HELP {m} latency histogram {k} of "
                         f"registry {r.name}")
            lines.append(f"# TYPE {m} histogram")
            h.render(m, lines)
    return "\n".join(lines) + "\n"
